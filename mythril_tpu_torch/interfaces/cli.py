"""The command-line interface of the PyTorch port (own copy of
``mythril_tpu/interfaces/cli.py``).

Commands: ``analyze`` (``a``), ``disassemble`` (``d``), ``pro``,
``truffle``, ``serve``, ``worker``, ``top``, ``watch``, ``read-storage``,
``leveldb-search``, ``function-to-hash``, ``hash-to-address``,
``list-detectors``, ``version`` and ``help``.  Run it as::

    python3 -m mythril_tpu_torch analyze -f CODE.hex --bin-runtime -t 2 \\
        --no-onchain-data [--workers 2] [-j STATES.json] [-g GRAPH.html]
    python3 -m mythril_tpu_torch analyze X.sol[:NAME] [--solv 0.8.19] \\
        [--solc-json SETTINGS] -t 1
    python3 -m mythril_tpu_torch truffle -t 1      # in a truffle project
    python3 -m mythril_tpu_torch leveldb-search 'code#PUSH1#' \\
        --leveldb-dir CHAINDATA
    python3 -m mythril_tpu_torch hash-to-address 0xCODEHASH \\
        --leveldb-dir CHAINDATA
    MYTHX_API_URL=URL python3 -m mythril_tpu_torch pro -f CODE.hex
    python3 -m mythril_tpu_torch analyze -a ADDRESS --rpc HOST:PORT -t 1
    python3 -m mythril_tpu_torch read-storage 0,2 ADDRESS --rpc HOST:PORT
    python3 -m mythril_tpu_torch function-to-hash 'transfer(address,uint256)'
    python3 -m mythril_tpu_torch watch --rpc HOST:PORT --until-block N \\
        [--journal FILE [--resume]] [--findings-out FILE] [--serve URL]
    python3 -m mythril_tpu_torch worker --connect HOST:PORT \\
        --secret-file FILE
    python3 -m mythril_tpu_torch serve --port 8551 [--fleet-listen H:P]
    python3 -m mythril_tpu_torch top --url http://127.0.0.1:8551 [--once]
    python3 -m mythril_tpu_torch --epic version

``analyze`` runs the JAX package's analysis (no slice pin is left:
``support/support_args.py``), with the word tier and the host word probing on, as the JAX default
(``MYTHRIL_TPU_WORD_TIER=0`` turns the tier off), the dispatcher
pre-split and the concrete replay of exploit sequences on, as the JAX
default (``--no-lockstep-dispatch`` turns the pre-split off), with the
veritesting tier on, as the JAX default (sibling lanes merged where
they re-converge and subsumed lanes retired between scheduler rounds;
``MYTHRIL_TPU_VERITEST=0`` pins the fork-only path), and puts
the solver tiers and the lockstep interpreter on the card, behind the
JAX funnel's default dispatch rungs (profit gate, async prefetch,
coalescer; ``--device-force-dispatch`` and ``--no-async-dispatch`` as in
the JAX CLI).  ``--device cpu`` is the only way to run it on the CPU;
without a card the command exits 2 with a clear message.  The lane
ledger and the autopilot are on, as the JAX default
(``MYTHRIL_TPU_LEDGER=0`` / ``MYTHRIL_TPU_AUTOPILOT=0`` are their kill
switches); ``--trace-out``, ``--metrics-out`` and ``--lane-ledger-out``
write the observability plane's artifacts.  The resilience plane is
on, as the JAX default: ``--checkpoint-dir DIR`` journals the analysis
and ``--resume DIR`` continues a killed one; SIGTERM/SIGINT drain it to
a partial report (``meta.resilience.partial``); ``MYTHRIL_TPU_FAULT``
and ``MYTHRIL_TPU_KILL_AT`` arm the fault plane, and a malformed spec
exits 2.  A lost card (``ops/device_health.DeviceLost``) is printed and
exits 1.  ``--persist-dir DIR`` keeps the knowledge plane's store in
DIR (solver memos and autopilot cells warm a later analysis of the same
bytecode; ``MYTHRIL_TPU_PERSIST=0`` is its kill switch), and
``--proof-log`` records the native solver's proof stream and certifies
every UNSAT verdict (the card's refutations among them, each confirmed
by a bounded host solve) with the independent checker of
``smt/drat.py`` before the report ships.  ``--workers N`` shards the
frontier across N worker processes at the first transaction boundary
with at least ``MYTHRIL_TPU_FLEET_MIN_STATES`` (default 2) open states
(``parallel/fleet.py``; ``MYTHRIL_TPU_FLEET=0`` is its kill switch), and
``worker`` runs a seat that attaches to such a coordinator from
elsewhere (``MYTHRIL_TPU_FLEET_LISTEN`` and
``MYTHRIL_TPU_FLEET_SECRET_FILE`` on the coordinator's side, or
``serve --fleet-listen``).  ``-j`` and ``-g`` write the statespace as
JSON and the call graph as HTML and end the command, as in the JAX CLI;
``--enable-coverage-strategy`` and ``--parallel-solving`` are the JAX
CLI's.  ``serve`` runs the analysis daemon (``serve/``) on the card of
``--device``; a lost card ends it with exit 1.  ``top`` renders a
running server's status, and ``--epic`` pipes the command's output
through the rainbow pager (``interfaces/epic.py``).  Entry-point
plugins (``plugin/``) are loaded before ``analyze`` and
``disassemble``, as in the JAX CLI.  On-chain data is the JAX CLI's:
``-a ADDRESS`` loads the runtime code at an address through the RPC
client (``--rpc HOST:PORT``, a comma-separated pool, ``ganache`` or
``infura-NET``; ``--rpctls``), triaged and with an EIP-1167 proxy chain
resolved; without ``--rpc`` the provider comes from
``~/.mythril_tpu/config.ini`` (``MYTHRIL_DIR``), and the executor's
loader is active unless ``--no-onchain-data`` is given.  The card is
checked before any RPC traffic.  ``read-storage`` reads storage slots
over RPC and ``function-to-hash`` prints a selector; neither uses the
card.  ``watch`` follows a chain and analyzes every new deployment on
the card of ``--device`` (or through ``--serve URL``): a lost card ends
it with exit 1, and ``--resume`` from its journal loses no block.
Solidity input (``X.sol``, ``X.sol:NAME``) is compiled by the ``solc`` on
``PATH`` (``--solv V`` picks ``solc-V``, ``solcV`` or ``solc``; nothing is
downloaded; ``--solc-json`` passes solc's settings), and its findings
carry the source's file, line and code through solc's source maps
(``solidity/soliditycontract.py``); without a solc the command ends with
a one-line compiler error.  ``truffle`` analyzes every artifact of a
truffle project's ``build/contracts`` on the card of ``--device``.
``leveldb-search`` and ``hash-to-address`` read a geth LevelDB
(``--leveldb-dir``, else the config's ``leveldb_dir``;
``ethereum/interface/leveldb/``), and ``pro`` submits contracts to the
analysis API at ``MYTHX_API_URL`` (``mythx/``); none of the three uses
the card.  ``-q`` is the JAX CLI's: the online signature lookup it asks
for does nothing, as in the JAX package.  A malformed ``MYTHRIL_TPU_*``
knob exits 2 at startup (``support/env.py:validate_env``).
"""

import argparse
import json
import logging
import os
import sys

import mythril_tpu_torch
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.exceptions import (
    CriticalError,
    DetectorNotFoundError,
    LoaderError,
    ProviderExhaustedError,
)
from mythril_tpu_torch.mythril import (
    MythrilAnalyzer,
    MythrilConfig,
    MythrilDisassembler,
)

log = logging.getLogger(__name__)

ANALYZE_LIST = ("analyze", "a")
DISASSEMBLE_LIST = ("disassemble", "d")


def exit_with_error(format_: str, message: str, code: int = 1) -> None:
    if format_ in ("text", "markdown"):
        print(message, file=sys.stderr)
    elif format_ == "json":
        print(json.dumps({"success": False, "error": str(message), "issues": []}))
    else:
        print(json.dumps([{
            "issues": [], "sourceType": "", "sourceFormat": "",
            "sourceList": [],
            "meta": {"logs": [{"level": "error", "hidden": True,
                               "error": message}]},
        }]))
    sys.exit(code)


def _add_input_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "-c", "--code",
        help='hex-encoded bytecode string ("6060604052...")',
        metavar="BYTECODE",
    )
    parser.add_argument(
        "-f", "--codefile",
        help="file containing hex-encoded bytecode string",
        metavar="BYTECODEFILE",
        type=argparse.FileType("r"),
    )
    parser.add_argument(
        "-a", "--address",
        help="pull contract from the blockchain",
        metavar="CONTRACT_ADDRESS",
    )
    parser.add_argument(
        "--bin-runtime",
        action="store_true",
        help="Consider the input bytecode as binary runtime code, default "
        "being the contract creation bytecode.",
    )
    _add_rpc_args(parser)
    _add_solidity_files(parser)
    _add_utility_args(parser)


def _add_solidity_files(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "solidity_files", nargs="*",
        help="Inputs file name and contract name. usage: file:contractName",
    )


def _add_utility_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--solc-json",
        help="Json for the optional 'settings' parameter of solc's "
        "standard-json input",
    )
    parser.add_argument(
        "--solv", help="specify solidity compiler version.", metavar="SOLV",
    )
    parser.add_argument(
        "-v", type=int, help="log level (0-5)", metavar="LOG_LEVEL",
        default=2, dest="verbosity",
    )


def _add_rpc_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--rpc",
        help="custom RPC settings",
        metavar="HOST:PORT / ganache / infura-[network_name]",
    )
    parser.add_argument(
        "--rpctls", type=bool, default=False, help="RPC connection over TLS"
    )


def _add_output_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "-o", "--outform",
        choices=["text", "markdown", "json", "jsonv2"],
        default="text",
        help="report output format",
        metavar="<text/markdown/json/jsonv2>",
    )
    parser.add_argument(
        "--verbose-report", action="store_true",
        help="Include debugging information in report (recorded; nothing "
        "reads it, as in the JAX package)",
    )


def create_analyzer_parser(parser: argparse.ArgumentParser,
                           device: bool = True) -> None:
    commands = parser.add_argument_group("commands")
    commands.add_argument(
        "-g", "--graph", help="generate a control flow graph",
        metavar="OUTPUT_FILE",
    )
    commands.add_argument(
        "-j", "--statespace-json", help="dumps the statespace json",
        metavar="OUTPUT_FILE",
    )
    options = parser.add_argument_group("options")
    options.add_argument(
        "-m", "--modules",
        help="Comma-separated list of security analysis modules",
        metavar="MODULES",
    )
    options.add_argument(
        "--max-depth", type=int, default=128,
        help="Maximum recursion depth for symbolic execution",
    )
    options.add_argument(
        "--call-depth-limit", type=int, default=3,
        help="Maximum call depth limit for symbolic execution",
    )
    options.add_argument(
        "--strategy",
        choices=["dfs", "bfs", "naive-random", "weighted-random"],
        default="bfs",
        help="Symbolic execution strategy",
    )
    options.add_argument(
        "-b", "--loop-bound", type=int, default=3,
        help="Bound loops at n iterations", metavar="N",
    )
    options.add_argument(
        "-t", "--transaction-count", type=int, default=2,
        help="Maximum number of transactions issued by laser",
    )
    options.add_argument(
        "--execution-timeout", type=int, default=86400,
        help="The amount of seconds to spend on symbolic execution",
    )
    options.add_argument(
        "--solver-timeout", type=int, default=10000,
        help="The maximum amount of time (in milli seconds) the solver "
        "spends for queries from analysis modules",
    )
    options.add_argument(
        "--create-timeout", type=int, default=10,
        help="The amount of seconds to spend on the initial contract creation",
    )
    options.add_argument(
        "--parallel-solving", action="store_true",
        help="Enable solving parallelization (recorded; nothing reads "
        "it, as in the JAX package)",
    )
    options.add_argument(
        "--no-batched-solving", action="store_true",
        help="Disable the batched frontier feasibility path (per-state "
        "solving only)",
    )
    options.add_argument(
        "--device-force-dispatch", action="store_true",
        help="Dispatch frontiers to the device whenever the size gates "
        "allow, bypassing the adaptive profit gate",
    )
    options.add_argument(
        "--lockstep-dispatch", action="store_true",
        help="Pre-split transaction seeds by function selector via the "
        "lockstep-validated dispatcher plan (the default; kept for "
        "script compatibility)",
    )
    options.add_argument(
        "--no-lockstep-dispatch", action="store_true",
        help="Disable the dispatcher pre-split: every transaction seed "
        "executes the full dispatcher prefix symbolically",
    )
    options.add_argument(
        "--no-async-dispatch", action="store_true",
        help="Disable the asynchronous device prefetch (profit-gate-"
        "declined frontiers solved on the device without blocking; see "
        "ops/async_dispatch.py)",
    )
    options.add_argument(
        "--no-onchain-data", action="store_true",
        help="Don't retrieve contract code, variables and balances from "
        "the blockchain",
    )
    options.add_argument(
        "--sparse-pruning", action="store_true",
        help="Checks for reachability after the end of tx",
    )
    options.add_argument(
        "--unconstrained-storage", action="store_true",
        help="Default storage value is symbolic",
    )
    options.add_argument(
        "--phrack", action="store_true", help="Phrack-style call graph",
    )
    options.add_argument(
        "--enable-physics", action="store_true",
        help="enable graph physics simulation",
    )
    options.add_argument(
        "-q", "--query-signature", action="store_true",
        help="Lookup function signatures through www.4byte.directory "
        "(accepted; there is no network, so the lookup does nothing, as "
        "in the JAX package)",
    )
    options.add_argument(
        "--enable-iprof", action="store_true",
        help="enable the instruction profiler",
    )
    options.add_argument(
        "--enable-coverage-strategy", action="store_true",
        help="enable coverage based search strategy",
    )
    options.add_argument(
        "--disable-dependency-pruning", action="store_true",
        help="Deactivate dependency-based pruning",
    )
    options.add_argument(
        "--custom-modules-directory",
        help="designates a separate directory to search for custom "
        "analysis modules",
        metavar="CUSTOM_MODULES_DIRECTORY",
    )
    options.add_argument(
        "--attacker-address",
        help="Designates a specific attacker address to use during analysis",
        metavar="ATTACKER_ADDRESS",
    )
    options.add_argument(
        "--creator-address",
        help="Designates a specific creator address to use during analysis",
        metavar="CREATOR_ADDRESS",
    )
    options.add_argument(
        "--trace-out",
        help="Write a Chrome/Perfetto trace_event JSON timeline of the "
        "analysis to FILE: hierarchical spans across CLI -> analyzer -> "
        "svm transactions -> pruning -> the funnel's tiers -> solver "
        "rounds -> H2D uploads -> the CDCL tail",
        metavar="FILE",
    )
    options.add_argument(
        "--metrics-out",
        help="Dump the unified metrics registry (dispatch, async-prefetch, "
        "lane-ledger, autopilot and trace counters) in Prometheus text "
        "format to FILE when the analysis ends",
        metavar="FILE",
    )
    options.add_argument(
        "--lane-ledger-out",
        help="Write the per-lane attribution ledger to FILE as JSON "
        "(schema mythril-tpu-lane-ledger/2): every funnel lane's origin, "
        "tier transitions, verdict, features and route, plus per-tier/"
        "per-contract aggregates; check with scripts/trace_lint.py",
        metavar="FILE",
    )
    options.add_argument(
        "--workers", type=int, default=None, metavar="N",
        help="Shard the transaction-boundary frontier across N fleet "
        "worker processes (coordinator/worker leases with heartbeat "
        "failure detection, journal re-lease, and epoch-fenced "
        "knowledge gossip).  0 forces the single-process path; default "
        "defers to MYTHRIL_TPU_FLEET_WORKERS (kill switch "
        "MYTHRIL_TPU_FLEET=0)",
    )
    options.add_argument(
        "--checkpoint-dir",
        help="Journal the analysis (frontier, findings, solver memo "
        "channels) into this directory so a killed run can be resumed; "
        "cadence via MYTHRIL_TPU_CHECKPOINT_PERIOD (seconds, default 30)",
        metavar="DIR",
    )
    options.add_argument(
        "--resume",
        dest="resume_dir",
        help="Resume a killed or drained analysis from the journal in DIR "
        "(implies --checkpoint-dir DIR); findings are those of an "
        "uninterrupted run",
        metavar="DIR",
    )
    options.add_argument(
        "--persist-dir",
        help="directory for the persistent knowledge store: solver "
        "memos and autopilot EWMAs survive the process and warm-start "
        "later analyses of the same bytecode (env: "
        "MYTHRIL_TPU_PERSIST_DIR; kill switch MYTHRIL_TPU_PERSIST=0)",
        metavar="DIR",
    )
    options.add_argument(
        "--proof-log", action="store_true",
        help="Record a DRAT-style proof stream on the native solver and "
        "certify every UNSAT verdict with the independent checker "
        "before reporting (wrong-UNSAT defense; adds memory and time)",
    )
    if device:
        options.add_argument(
            "--device", choices=["cuda", "cpu"], default="cuda",
            help="Where the dense tier runs: the card (default; an error "
            "without one) or, only when asked for, the CPU",
        )


def create_serve_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--host", default="127.0.0.1",
        help="interface to bind (default 127.0.0.1)",
    )
    parser.add_argument(
        "-p", "--port", type=int, default=8551,
        help="TCP port to listen on (0 = ephemeral)",
    )
    parser.add_argument(
        "--trace-out", metavar="FILE",
        help="Write the server's Perfetto span timeline here on drain "
        "(every request gets a serve.request span tree)",
    )
    parser.add_argument(
        "--metrics-out", metavar="FILE",
        help="Also dump the metrics registry to FILE on drain (the live "
        "view is GET /metrics)",
    )
    parser.add_argument(
        "--lane-ledger-out", metavar="FILE",
        help="Also dump the per-lane attribution ledger to FILE on drain "
        "(the live view is GET /debug/lanes)",
    )
    parser.add_argument(
        "--fleet-listen", metavar="HOST:PORT",
        help="HOST:PORT the serving fabric's coordinator listens on for "
        "`worker --connect` attach (non-loopback requires --secret-file; "
        "env: MYTHRIL_TPU_FLEET_LISTEN)",
    )
    parser.add_argument(
        "--secret-file", metavar="FILE",
        help="shared-secret file authenticating fabric workers (env: "
        "MYTHRIL_TPU_FLEET_SECRET_FILE)",
    )
    parser.add_argument(
        "--persist-dir", metavar="DIR",
        help="directory for the persistent knowledge store: loaded at "
        "startup, flushed on drain; a re-submitted contract is answered "
        "from its report cache (env: MYTHRIL_TPU_PERSIST_DIR)",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Where every request's analysis runs: the card (default; "
        "an error without one) or, only when asked for, the CPU",
    )
    # the JAX CLI's serve takes them too; a request brings its own
    # bytecode and solc settings
    _add_utility_args(parser)


def create_top_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--url", default="http://127.0.0.1:8551",
        help="base URL of a running serve daemon (or a fleet "
        "coordinator's MYTHRIL_TPU_FLEET_DEBUG_PORT listener)",
    )
    parser.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh period in seconds",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="render a single snapshot and exit (no screen clearing)",
    )


def create_worker_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--connect", required=True, metavar="HOST:PORT",
        help="HOST:PORT of a --workers N coordinator's fleet listener "
        "(MYTHRIL_TPU_FLEET_LISTEN on its side)",
    )
    parser.add_argument(
        "--secret-file", metavar="FILE",
        help="shared-secret file for the fabric handshake (env: "
        "MYTHRIL_TPU_FLEET_SECRET_FILE; required when the coordinator "
        "listens on a routable interface)",
    )
    parser.add_argument(
        "--id", metavar="ID",
        help="worker id announced in the hello (default HOSTNAME-PID)",
    )
    parser.add_argument(
        "--persist-dir", metavar="DIR",
        help="directory for the persistent knowledge store of this seat "
        "(env: MYTHRIL_TPU_PERSIST_DIR)",
    )
    parser.add_argument(
        "--reconnect", type=int, default=None, metavar="N",
        help="redial attempts after a lost coordinator connection "
        "(default MYTHRIL_TPU_FLEET_RECONNECT or 5; 0 = exit on the "
        "first disconnect)",
    )
    parser.add_argument(
        "-v", type=int, help="log level (0-5)", metavar="LOG_LEVEL",
        default=2, dest="verbosity",
    )


def create_watch_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--rpc",
        help="comma-separated RPC providers (URL or HOST[:PORT] each; "
        "env: MYTHRIL_TPU_RPC_PROVIDERS) the chain follower polls",
        metavar="SPEC",
    )
    parser.add_argument(
        "--serve",
        help="base URL of a running `serve` daemon to stream deployments "
        "into (default: an in-process engine on the card of --device)",
        metavar="URL",
    )
    parser.add_argument(
        "--from-block", type=int, default=None, metavar="N",
        help="backfill start height (env: MYTHRIL_TPU_WATCH_FROM_BLOCK; "
        "default 0)",
    )
    parser.add_argument(
        "--until-block", type=int, default=None, metavar="N",
        help="stop once the cursor reaches N and the backlog is empty "
        "(default: follow forever until drained)",
    )
    parser.add_argument(
        "--confirmations", type=int, default=None, metavar="N",
        help="confirmation-depth lag behind the head (env: "
        "MYTHRIL_TPU_WATCH_CONFIRMATIONS; default 2)",
    )
    parser.add_argument(
        "--poll-s", type=float, default=None, metavar="S",
        help="head poll period in seconds when caught up (env: "
        "MYTHRIL_TPU_WATCH_POLL_S; default 2.0)",
    )
    parser.add_argument(
        "--journal", metavar="FILE",
        help="fsynced cursor journal; with --resume a killed watcher "
        "continues losing no block and re-analyzing nothing",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="replay --journal before following (cursor, seen digests, "
        "pending submissions)",
    )
    parser.add_argument(
        "--findings-out", metavar="FILE",
        help="JSONL findings sink: one row per submission outcome "
        "(analyzed / cached / duplicate / error)",
    )
    parser.add_argument(
        "--tx-count", type=int, default=2, metavar="N",
        help="transaction depth per analysis",
    )
    parser.add_argument(
        "--deadline-s", type=float, default=None, metavar="S",
        help="per-analysis wall-clock budget (default: the serve plane's "
        "default deadline)",
    )
    parser.add_argument(
        "--trace-out", metavar="FILE",
        help="Write the watcher's Perfetto span timeline here on exit "
        "(watch.poll/block/extract/submit spans)",
    )
    parser.add_argument(
        "--metrics-out", metavar="FILE",
        help="Dump the metrics registry (mythril_tpu_watch_*) to FILE on "
        "exit",
    )
    parser.add_argument(
        "--persist-dir", metavar="DIR",
        help="directory for the persistent knowledge store: the report "
        "cache that makes re-submissions answer cached (env: "
        "MYTHRIL_TPU_PERSIST_DIR)",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Where the in-process engine analyzes: the card (default; an "
        "error without one) or, only when asked for, the CPU",
    )


def run_worker(args: argparse.Namespace) -> int:
    """A worker seat attached to a coordinator (``parallel/fleet.py``);
    the caller has set ``MYTHRIL_TPU_FLEET_ROLE=worker``."""
    import socket

    from mythril_tpu_torch.parallel.fleet import worker_main

    worker_id = args.id or f"{socket.gethostname()}-{os.getpid()}"
    argv = ["--worker", "--connect", args.connect, "--id", worker_id]
    if args.secret_file:
        argv += ["--secret-file", args.secret_file]
    reconnect = args.reconnect
    if reconnect is None and not os.environ.get(
            "MYTHRIL_TPU_FLEET_RECONNECT"):
        reconnect = 5  # a coordinator restart is a pause, not a death
    if reconnect is not None:
        argv += ["--reconnect", str(reconnect)]
    return worker_main(argv)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python3 -m mythril_tpu_torch",
        description="Security analysis of Ethereum smart contracts "
        "(PyTorch/CUDA port)",
    )
    parser.add_argument("--epic", action="store_true", help=argparse.SUPPRESS)
    subparsers = parser.add_subparsers(dest="command", help="Commands")
    analyzer_parser = subparsers.add_parser(
        ANALYZE_LIST[0], aliases=ANALYZE_LIST[1:],
        help="Triggers the analysis of the smart contract",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    _add_input_args(analyzer_parser)
    _add_output_args(analyzer_parser)
    create_analyzer_parser(analyzer_parser)
    disassemble_parser = subparsers.add_parser(
        DISASSEMBLE_LIST[0], aliases=DISASSEMBLE_LIST[1:],
        help="Disassembles the smart contract",
    )
    _add_input_args(disassemble_parser)
    pro_parser = subparsers.add_parser(
        "pro",
        help="Submits the contract to a cloud analysis endpoint "
        "(requires MYTHX_API_URL)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    _add_input_args(pro_parser)
    _add_output_args(pro_parser)
    create_analyzer_parser(pro_parser, device=False)
    truffle_parser = subparsers.add_parser(
        "truffle",
        help="Analyze a truffle project (run from the project directory)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    _add_solidity_files(truffle_parser)
    _add_utility_args(truffle_parser)
    _add_output_args(truffle_parser)
    create_analyzer_parser(truffle_parser)
    serve_parser = subparsers.add_parser(
        "serve",
        help="Run the persistent analysis daemon: bounded admission, "
        "per-request deadline budgets, request isolation, live /healthz "
        "/readyz /metrics",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    create_serve_parser(serve_parser)
    worker_parser = subparsers.add_parser(
        "worker",
        help="Runs a fleet worker seat attached to a --workers N "
        "coordinator or a serve --fleet-listen endpoint",
    )
    create_worker_parser(worker_parser)
    top_parser = subparsers.add_parser(
        "top",
        help="Live one-screen status of a running serve daemon or fleet "
        "coordinator",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    create_top_parser(top_parser)
    watch_parser = subparsers.add_parser(
        "watch",
        help="Follow new blocks on a live chain and stream every newly "
        "deployed contract through the serve plane: reorg-tolerant "
        "cursor, clone/proxy dedup, backpressure backlog",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    create_watch_parser(watch_parser)
    read_storage_parser = subparsers.add_parser(
        "read-storage",
        help="Retrieves storage slots from a given address through rpc",
    )
    read_storage_parser.add_argument(
        "storage_slots",
        help="read state variables from storage index",
        metavar="INDEX,NUM_SLOTS,[array] / mapping,INDEX,[KEY1, KEY2...]",
    )
    read_storage_parser.add_argument(
        "address", help="contract address", metavar="CONTRACT_ADDRESS"
    )
    _add_rpc_args(read_storage_parser)
    func_to_hash_parser = subparsers.add_parser(
        "function-to-hash", help="Returns the hash of a function signature"
    )
    func_to_hash_parser.add_argument(
        "func_name", help="calculate function signature hash",
        metavar="SIGNATURE",
    )
    hash_to_addr_parser = subparsers.add_parser(
        "hash-to-address",
        help="Returns the address for a contract code hash (LevelDB)",
    )
    hash_to_addr_parser.add_argument(
        "hash",
        help="contract code hash (0x + 64 hex chars) to resolve to an "
        "address",
        metavar="HASH",
    )
    _add_leveldb_dir(hash_to_addr_parser)
    leveldb_search_parser = subparsers.add_parser(
        "leveldb-search", help="Searches the code fragment in local leveldb"
    )
    leveldb_search_parser.add_argument(
        "search", help="search expression", metavar="EXPRESSION"
    )
    _add_leveldb_dir(leveldb_search_parser)
    list_parser = subparsers.add_parser(
        "list-detectors", help="Lists available detection modules",
    )
    _add_output_args(list_parser)
    version_parser = subparsers.add_parser(
        "version", help="Outputs the version",
    )
    _add_output_args(version_parser)
    subparsers.add_parser("help", add_help=False)
    return parser


def _add_leveldb_dir(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--leveldb-dir",
        help="specify leveldb directory for search or direct access "
        "operations",
        metavar="LEVELDB_PATH",
    )


def set_config(args: argparse.Namespace) -> MythrilConfig:
    """The JAX CLI's ``set_config``: ``--rpc`` wins; else, unless
    ``--no-onchain-data`` is given (or the command has no such flag),
    the provider of ``config.ini`` (``eth`` stays None when it names
    Infura and ``INFURA_ID`` is unset)."""
    config = MythrilConfig()
    if getattr(args, "rpc", None):
        config.set_api_rpc(rpc=args.rpc, rpctls=args.rpctls)
    elif not getattr(args, "no_onchain_data", True):
        config.set_api_from_config_path()
    return config


def load_code(disassembler: MythrilDisassembler, args: argparse.Namespace):
    if args.code is not None:
        address, _ = disassembler.load_from_bytecode(
            args.code, args.bin_runtime
        )
    elif args.codefile:
        bytecode = "".join(
            line.strip() for line in args.codefile if line.strip()
        )
        address, _ = disassembler.load_from_bytecode(
            bytecode, args.bin_runtime
        )
    elif args.address:
        address, _ = disassembler.load_from_address(args.address)
    elif args.solidity_files:
        address, _ = disassembler.load_from_solidity(args.solidity_files)
    else:
        exit_with_error(
            getattr(args, "outform", "text"),
            "No input bytecode. Please provide EVM code via -c BYTECODE, "
            "-a ADDRESS, -f BYTECODE_FILE or <SOLIDITY_FILE>",
        )
    return address


def _check_device(args) -> None:
    """Exit 2 without the card of ``--device`` (before any RPC traffic)."""
    from mythril_tpu_torch.ops import default_device

    try:
        default_device(args.device)
    except RuntimeError as e:
        exit_with_error(args.outform, f"{e} (use --device cpu)", code=2)


def _analyze(disassembler, address, args) -> int:
    if args.attacker_address or args.creator_address:
        from mythril_tpu_torch.laser.ethereum.transaction.symbolic import (
            ACTORS,
        )

        for actor, value in (("ATTACKER", args.attacker_address),
                             ("CREATOR", args.creator_address)):
            if not value:
                continue
            try:
                ACTORS[actor] = int(value, 16)
            except ValueError:
                exit_with_error(args.outform,
                                f"{actor.title()} address is invalid")
    analyzer = _build_analyzer(disassembler, address, args,
                               use_onchain_data=not args.no_onchain_data)
    if not disassembler.contracts:
        exit_with_error(
            args.outform, "input files do not contain any valid contracts"
        )
    if args.graph:
        html = analyzer.graph_html(
            contract=analyzer.contracts[0],
            enable_physics=args.enable_physics,
            phrackify=args.phrack,
            transaction_count=args.transaction_count,
        )
        try:
            with open(args.graph, "w") as f:
                f.write(html)
        except Exception as e:
            exit_with_error(args.outform, f"Error saving graph: {e}")
        return 0
    if args.statespace_json:
        statespace = analyzer.dump_statespace(contract=analyzer.contracts[0])
        try:
            with open(args.statespace_json, "w") as f:
                json.dump(statespace, f)
        except Exception as e:
            exit_with_error(args.outform, f"Error saving json: {e}")
        return 0
    return _fire_and_print(analyzer, args)


def _build_analyzer(disassembler, address, args,
                    use_onchain_data: bool) -> MythrilAnalyzer:
    """The analyzer of ``analyze`` and ``truffle`` from the CLI's flags
    (one construction point, as in the JAX CLI)."""
    return MythrilAnalyzer(
        disassembler=disassembler,
        strategy=args.strategy,
        address=address,
        max_depth=args.max_depth,
        execution_timeout=args.execution_timeout,
        loop_bound=args.loop_bound,
        create_timeout=args.create_timeout,
        enable_iprof=args.enable_iprof,
        disable_dependency_pruning=args.disable_dependency_pruning,
        use_onchain_data=use_onchain_data,
        solver_timeout=args.solver_timeout,
        custom_modules_directory=args.custom_modules_directory or "",
        sparse_pruning=args.sparse_pruning,
        unconstrained_storage=args.unconstrained_storage,
        call_depth_limit=args.call_depth_limit,
        batched_solving=not args.no_batched_solving,
        device_force_dispatch=args.device_force_dispatch,
        async_dispatch=not args.no_async_dispatch,
        lockstep_dispatch=not args.no_lockstep_dispatch,
        proof_log=args.proof_log,
        parallel_solving=args.parallel_solving,
        enable_coverage_strategy=args.enable_coverage_strategy,
        device=args.device,
        checkpoint_dir=args.checkpoint_dir,
        resume_from=args.resume_dir,
        fleet_workers=args.workers,
    )


def _fire_and_print(analyzer: MythrilAnalyzer, args) -> int:
    """Run the analysis and print its report; the exit code."""
    from mythril_tpu_torch.observability import finalize_outputs, span
    from mythril_tpu_torch.ops.device_health import DeviceLost

    try:
        with span("cli.analyze", cat="cli"):
            report = analyzer.fire_lasers(
                modules=[m.strip() for m in args.modules.strip().split(",")]
                if args.modules else None,
                transaction_count=args.transaction_count,
            )
            renderers = {
                "json": report.as_json,
                "jsonv2": report.as_swc_standard_format,
                "text": report.as_text,
                "markdown": report.as_markdown,
            }
            rendered = renderers[args.outform]()
    except DetectorNotFoundError as e:
        exit_with_error(args.outform, format(e))
    except DeviceLost as e:
        finalize_outputs()
        exit_with_error(args.outform, f"device lost: {e}")
    # the artifacts land before the report reaches stdout: a reader that
    # closes the pipe early must not cost the run its timeline
    finalize_outputs()
    print(rendered)
    if report.exceptions:
        # the analysis salvaged what it could, but a failure (the dense
        # tier or its kernel among them) must not read as a clean run
        print("analysis failed:\n" + "\n".join(report.exceptions),
              file=sys.stderr)
        return 1
    return 0


def run_epic(argv) -> int:
    """``--epic``: run the command again without the flag, its output
    piped through the rainbow pager (``interfaces/epic.py``)."""
    import shlex
    import subprocess

    interpreter = shlex.quote(sys.executable or "python3")
    package_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.realpath(__file__))))
    pager = os.path.join(os.path.dirname(os.path.realpath(__file__)),
                         "epic.py")
    command = (
        f"{interpreter} -m mythril_tpu_torch "
        + " ".join(shlex.quote(arg) for arg in argv if arg != "--epic")
        + f" | {interpreter} {shlex.quote(pager)}"
    )
    # the re-run finds this package where this process found it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (package_root, os.environ.get("PYTHONPATH")))))
    return subprocess.call(command, shell=True, env=env)


def run_serve(args: argparse.Namespace) -> int:
    """``serve``: the analysis daemon on the card of ``--device``, until
    SIGTERM/SIGINT drains it (exit 0) or the card is lost (exit 1)."""
    from mythril_tpu_torch.ops import default_device
    from mythril_tpu_torch.serve import ServeConfigError, run_server

    try:
        default_device(args.device)
    except RuntimeError as e:
        print(f"{e} (use --device cpu)", file=sys.stderr)
        return 2
    try:
        return run_server(
            host=args.host, port=args.port,
            fleet_listen=args.fleet_listen,
            secret_file=args.secret_file, device=args.device,
        )
    except ServeConfigError as e:
        print(f"bad serve config: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"cannot bind {args.host}:{args.port}: {e}", file=sys.stderr)
        return 1


def run_truffle(args: argparse.Namespace) -> int:
    """``truffle``: every ``build/contracts/*.json`` artifact of the
    project in the working directory with runtime code, analyzed as
    ``analyze --bin-runtime`` and named by its ``contractName``
    (interfaces and unreadable JSON skipped), without on-chain data, as
    the JAX CLI's ``execute_truffle`` does."""
    outform = args.outform
    build_dir = os.path.join(os.getcwd(), "build", "contracts")
    if not os.path.isdir(build_dir):
        exit_with_error(
            outform,
            "No build/contracts directory here. Run `truffle compile` in "
            "the project first, then `myth truffle` from the project root.",
        )
    _check_device(args)
    disassembler = MythrilDisassembler(eth=None)
    address = None
    for filename in sorted(os.listdir(build_dir)):
        if not filename.endswith(".json"):
            continue
        with open(os.path.join(build_dir, filename)) as fh:
            try:
                artifact = json.load(fh)
            except json.JSONDecodeError:
                continue
        runtime = (artifact.get("deployedBytecode") or "").strip()
        if runtime in ("", "0x"):
            continue  # interfaces and abstract contracts have no code
        loaded_address, _ = disassembler.load_from_bytecode(
            runtime, bin_runtime=True
        )
        address = address or loaded_address
        disassembler.contracts[-1].name = artifact.get(
            "contractName", filename[:-5]
        )
    if not disassembler.contracts:
        exit_with_error(
            outform, "No deployable contracts found in build/contracts."
        )
    return _fire_and_print(
        _build_analyzer(disassembler, address, args, use_onchain_data=False),
        args,
    )


def run_leveldb(args: argparse.Namespace) -> int:
    """``leveldb-search`` and ``hash-to-address`` over the geth LevelDB
    of ``--leveldb-dir`` (else the config's ``leveldb_dir``)."""
    from mythril_tpu_torch.mythril.mythril_leveldb import MythrilLevelDB

    config = MythrilConfig()
    leveldb_dir = args.leveldb_dir or config.leveldb_dir
    try:
        config.set_api_leveldb(leveldb_dir)
    except Exception as e:  # noqa: BLE001 — any unreadable database
        exit_with_error("text", f"Cannot open LevelDB at {leveldb_dir}: {e}")
    searcher = MythrilLevelDB(config.eth_db)
    try:
        if args.command == "leveldb-search":
            searcher.search_db(args.search)
        else:
            searcher.contract_hash_to_address(args.hash)
    except CriticalError as e:
        exit_with_error("text", str(e))
    return 0


def run_pro(disassembler: MythrilDisassembler, args) -> int:
    """``pro``: the loaded contracts submitted to the analysis API at
    ``MYTHX_API_URL`` (``mythx/``), its issues printed as a report."""
    from mythril_tpu_torch import mythx

    try:
        report = mythx.analyze(disassembler.contracts)
    except mythx.MythXApiError as e:
        raise CriticalError(str(e)) from e
    print(report.as_json() if args.outform == "json" else report.as_text())
    return 0


def run_read_storage(args: argparse.Namespace) -> int:
    """``read-storage``: the slots over RPC (``--rpc``, else
    ``localhost:8545``), one ``SLOT: VALUE`` line each."""
    try:
        config = set_config(args)
        if config.eth is None:
            config.set_api_rpc(args.rpc or "localhost:8545", args.rpctls)
        disassembler = MythrilDisassembler(eth=config.eth)
        print(disassembler.get_state_variable_from_storage(
            address=args.address,
            params=[a.strip() for a in args.storage_slots.strip().split(",")],
        ))
    except CriticalError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


def run_watch_command(args: argparse.Namespace) -> int:
    """``watch``, with the JAX CLI's one-line exit 2 for provider
    exhaustion and a bad serve config."""
    from mythril_tpu_torch.serve import ServeConfigError
    from mythril_tpu_torch.watch import run_watch

    try:
        return run_watch(args)
    except ProviderExhaustedError as e:
        print(json.dumps({"error": {"code": e.code, "message": str(e)}}),
              file=sys.stderr)
        return 2
    except ServeConfigError as e:
        print(f"bad serve config: {e}", file=sys.stderr)
        return 2


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.epic:
        sys.exit(run_epic(argv))
    if args.command is None:
        parser.print_help()
        sys.exit(2)
    if args.command == "help":
        parser.print_help()
        sys.exit(0)
    if args.command == "worker":
        # before anything of the fleet loads: a seat never shards again
        os.environ["MYTHRIL_TPU_FLEET_ROLE"] = "worker"

    if args.command == "version":
        version = mythril_tpu_torch.__version__
        if args.outform == "json":
            print(json.dumps({"version_str": version}))
        else:
            print(f"Mythril-TPU (PyTorch port) version {version}")
        sys.exit(0)

    # knobs are checked before any command runs, with the JAX CLI's
    # exit-2 contract: a typo'd value must not run a default
    from mythril_tpu_torch.support.env import EnvSpecError, validate_env

    try:
        validate_env()
    except EnvSpecError as e:
        print(f"bad environment knob: {e}", file=sys.stderr)
        sys.exit(2)

    if getattr(args, "persist_dir", None):
        # --persist-dir wins over the env knob (the knowledge plane reads
        # the directory from the environment)
        os.environ["MYTHRIL_TPU_PERSIST_DIR"] = args.persist_dir

    if os.environ.get("MYTHRIL_TPU_FAULT") or os.environ.get(
            "MYTHRIL_TPU_KILL_AT"):
        # a chaos schedule that would inject nothing dies here
        from mythril_tpu_torch.resilience.faults import (
            FaultSpecError, get_fault_plane,
        )

        try:
            get_fault_plane()
        except FaultSpecError as e:
            print(f"bad fault spec: {e}", file=sys.stderr)
            sys.exit(2)

    if args.command in ANALYZE_LIST or args.command in (
            "truffle", "serve", "watch"):
        # graceful drain: SIGTERM/SIGINT walk the cooperative boundaries,
        # land a final journal generation and ship a partial report (in
        # serve mode the same flag drains the daemon)
        from mythril_tpu_torch.resilience.checkpoint import (
            install_signal_handlers,
        )

        install_signal_handlers()
        # observability plane: --trace-out enables the span tracer, the
        # other two request their dumps at the end; all three hook the
        # flight recorder's crash dump
        from mythril_tpu_torch.observability import configure_from_cli

        configure_from_cli(args.trace_out, args.metrics_out,
                           getattr(args, "lane_ledger_out", None))

    if args.command == "list-detectors":
        modules = [
            {"classname": type(module).__name__, "title": module.name}
            for module in ModuleLoader().get_detection_modules()
        ]
        if args.outform == "json":
            print(json.dumps(modules))
        else:
            for module_data in modules:
                print(f"{module_data['classname']}: {module_data['title']}")
        sys.exit(0)

    if args.command == "pro":
        # before any compile or load: the endpoint is what the command
        # needs first
        from mythril_tpu_torch import mythx

        if mythx.api_url() is None:
            exit_with_error(
                args.outform,
                "The 'pro' command submits contracts to a cloud analysis "
                "endpoint; set MYTHX_API_URL to use it (this environment "
                "has no network egress by default).",
            )

    log_levels = [
        logging.NOTSET, logging.CRITICAL, logging.ERROR, logging.WARNING,
        logging.INFO, logging.DEBUG,
    ]
    level = log_levels[min(max(getattr(args, "verbosity", 2), 0), 5)]
    logging.basicConfig(
        level=level, format="%(name)s [%(levelname)s]: %(message)s"
    )
    logging.getLogger("mythril_tpu_torch").setLevel(level)

    if args.command == "worker":
        sys.exit(run_worker(args))
    if args.command == "serve":
        sys.exit(run_serve(args))
    if args.command == "top":
        from mythril_tpu_torch.interfaces.top import run_top

        sys.exit(run_top(args.url, interval_s=args.interval, once=args.once))
    if args.command == "watch":
        sys.exit(run_watch_command(args))
    if args.command == "function-to-hash":
        print(MythrilDisassembler.hash_for_function_signature(args.func_name))
        sys.exit(0)
    if args.command in ("hash-to-address", "leveldb-search"):
        sys.exit(run_leveldb(args))
    if args.command == "truffle":
        sys.exit(run_truffle(args))

    # entry-point plugins, as the JAX CLI loads them before analyze and
    # disassemble
    from mythril_tpu_torch.plugin.loader import MythrilPluginLoader

    MythrilPluginLoader()

    if args.command == "read-storage":
        sys.exit(run_read_storage(args))

    outform = getattr(args, "outform", "text")
    if args.command in ANALYZE_LIST:
        _check_device(args)
    try:
        config = set_config(args)
        disassembler = MythrilDisassembler(
            eth=config.eth,
            solc_version=args.solv,
            solc_settings_json=args.solc_json,
            enable_online_lookup=getattr(args, "query_signature", False),
        )
        address = load_code(disassembler, args)
        if args.command == "pro":
            sys.exit(run_pro(disassembler, args))
        if args.command in DISASSEMBLE_LIST:
            if not disassembler.contracts:
                exit_with_error(
                    outform, "input files do not contain any valid contracts"
                )
            contract = disassembler.contracts[0]
            if contract.code:
                print("Runtime Disassembly: \n" + contract.get_easm())
            if contract.creation_code:
                print("Disassembly: \n" + contract.get_creation_easm())
            sys.exit(0)
        sys.exit(_analyze(disassembler, address, args))
    except LoaderError as le:
        print(le.to_line(), file=sys.stderr)
        sys.exit(2)
    except CriticalError as ce:
        exit_with_error(outform, str(ce))


if __name__ == "__main__":
    main()
