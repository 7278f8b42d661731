"""The statespace as JSON for ``-j/--statespace-json`` (own copy of
``mythril_tpu/analysis/traceexplore.py``; reference:
mythril/analysis/traceexplore.py).  Node ids are the executor's node
uids (``laser/ethereum/cfg.py``), a counter of the process."""

from typing import Dict, List

colors = [
    {"border": "#26996f", "background": "#2f7e5b"},
    {"border": "#9e42b3", "background": "#842899"},
    {"border": "#b82323", "background": "#991d1d"},
    {"border": "#553aab", "background": "#30235d"},
]


def get_serializable_statespace(statespace) -> Dict:
    nodes: List[Dict] = []
    edges: List[Dict] = []

    color_map = {}
    i = 0
    for k in statespace.accounts:
        color_map[statespace.accounts[k].contract_name] = colors[i % len(colors)]
        i += 1

    for node_key in statespace.nodes:
        node = statespace.nodes[node_key]
        code = node.get_cfg_dict()["code"]
        code = code.replace("\\n", "\n")
        code_split = code.split("\n")
        truncated_code = (
            code
            if len(code_split) < 7
            else "\n".join(code_split[:6]) + "\n(click to expand +)"
        )
        color = color_map.get(node.contract_name, colors[0])

        state_detail_list = []
        for state in node.states:
            state_detail_list.append(
                {
                    "address": state.get_current_instruction()["address"],
                    "contract": node.contract_name,
                    "function": node.function_name,
                    "state": _serialize_state(state),
                }
            )
        nodes.append(
            {
                "id": str(node.uid),
                "func": str(node.function_name),
                "label": truncated_code,
                "code": code,
                "truncated": truncated_code,
                "states": state_detail_list,
                "color": color,
                "instructions": code_split,
            }
        )
    for edge in statespace.edges:
        if edge.condition is None:
            label = ""
        else:
            label = str(edge.condition)
        edges.append(
            {
                "from": str(edge.as_dict["from"]),
                "to": str(edge.as_dict["to"]),
                "arrows": "to",
                "label": label,
                "smooth": {"type": "cubicBezier"},
            }
        )
    return {"nodes": nodes, "edges": edges}


def _serialize_state(state) -> Dict:
    mstate = state.mstate
    return {
        "pc": mstate.pc,
        "opcode": state.get_current_instruction()["opcode"],
        "stack": [str(item) for item in mstate.stack],
        "memsize": mstate.memory_size,
        "gas": f"{mstate.min_gas_used}-{mstate.max_gas_used}",
    }
