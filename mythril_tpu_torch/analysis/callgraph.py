"""Interactive HTML call graph for ``-g/--graph`` (own copy of
``mythril_tpu/analysis/callgraph.py``; reference:
mythril/analysis/callgraph.py).

Renders the recorded statespace nodes/edges as a vis.js network.  The
vis.js library is referenced from a CDN; the HTML is self-contained
otherwise.  The JAX package fills the template with ``jinja2``; the port
substitutes the three placeholders itself, which gives the same bytes
(the JAX template environment does not autoescape, and ``{{ x }}``
prints ``str(x)``), so ``-g`` needs no ``jinja2``.
"""

import re

graph_html_template = """<!DOCTYPE html>
<html>
<head>
<title>Call Graph</title>
<script type="text/javascript"
 src="https://cdnjs.cloudflare.com/ajax/libs/vis/4.21.0/vis.min.js"></script>
<link rel="stylesheet" type="text/css"
 href="https://cdnjs.cloudflare.com/ajax/libs/vis/4.21.0/vis.min.css">
<style type="text/css">
 body {background-color: #232625; color: #cfe2e2;
       font-family: monospace; margin: 0;}
 #mynetwork {height: 100vh; background-color: #232625;}
</style>
</head>
<body>
<div id="mynetwork"></div>
<script>
var nodes = new vis.DataSet({{ nodes }});
var edges = new vis.DataSet({{ edges }});
var container = document.getElementById('mynetwork');
var data = {nodes: nodes, edges: edges};
var options = {
  autoResize: true,
  layout: {improvedLayout: true},
  physics: {enabled: {{ physics }}, stabilization: {enabled: true}},
  nodes: {color: '#87925f', borderWidth: 1, shape: 'box',
          font: {color: '#ffffff', face: 'monospace', size: 10},
          shapeProperties: {borderRadius: 0}},
  edges: {font: {color: '#c5c8c6', face: 'monospace', size: 9,
          strokeWidth: 0}, arrows: 'to', color: {color: '#57615e'}},
};
var network = new vis.Network(container, data, options);
</script>
</body>
</html>"""


def extract_nodes(statespace) -> list:
    nodes = []
    for key in statespace.nodes:
        node = statespace.nodes[key]
        code_lines = []
        for state in node.states:
            instruction = state.get_current_instruction()
            line = f"{instruction['address']} {instruction['opcode']}"
            if instruction.get("argument"):
                line += " " + instruction["argument"]
            code_lines.append(line)
        nodes.append(
            {
                "id": str(node.uid),
                "label": f"{node.function_name}\\n" + "\\n".join(code_lines[:20]),
                "fullLabel": "\\n".join(code_lines),
                "function_name": node.function_name,
                "isExpanded": False,
            }
        )
    return nodes


def extract_edges(statespace) -> list:
    edges = []
    for edge in statespace.edges:
        if edge.condition is None:
            label = ""
        else:
            label = re.sub(r"([^_])([\d]{2}\d+)", lambda m: m.group(1) + hex(int(m.group(2))), str(edge.condition))
        edges.append(
            {
                "from": str(edge.as_dict["from"]),
                "to": str(edge.as_dict["to"]),
                "arrows": "to",
                "label": label[:100],
                "smooth": {"type": "cubicBezier"},
            }
        )
    return edges


def generate_graph(statespace, physics: bool = False, phrackify: bool = False) -> str:
    """The graph's HTML page.  ``phrackify`` is accepted as in the JAX
    package, which renders the same page either way."""
    values = {
        "nodes": extract_nodes(statespace),
        "edges": extract_edges(statespace),
        "physics": str(physics).lower(),
    }
    # one pass, so that a placeholder inside a label stays as it is
    return re.sub(r"\{\{ (nodes|edges|physics) \}\}",
                  lambda m: str(values[m.group(1)]), graph_html_template)
