"""The command-line interface of the PyTorch port (own copy of
``mythril_tpu/interfaces/cli.py``, trimmed to bytecode analysis).

Commands: ``analyze`` (``a``), ``disassemble`` (``d``),
``list-detectors`` and ``version``.  Run it as::

    python3 -m mythril_tpu_torch analyze -f CODE.hex --bin-runtime -t 2 \\
        --no-onchain-data

``analyze`` runs the JAX package's analysis under the slice pins
(``support/support_args.py``: ``SLICE_PINS_ENV``/``SLICE_PINS_ARGS``,
with ``word_probing`` off) and puts the dense tier on the card.
``--device cpu`` is the only way to run it on the CPU; without a card
the command exits 2 with a clear message.  Options that would need a
part of the JAX package the port does not have (workers, checkpoints,
traces, RPC, solc, ...) are refused, not ignored, and so is
``MYTHRIL_TPU_FRONTIER=0``; a malformed ``MYTHRIL_TPU_*`` knob exits 2
at startup (``support/env.py:validate_env``).
"""

import argparse
import json
import logging
import sys

import mythril_tpu_torch
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.exceptions import (
    CriticalError,
    DetectorNotFoundError,
    LoaderError,
)
from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler

log = logging.getLogger(__name__)

ANALYZE_LIST = ("analyze", "a")
DISASSEMBLE_LIST = ("disassemble", "d")

#: options of the JAX CLI's analyze command that need a plane this port
#: does not have (``ROADMAP.md`` queues them); given one, the command
#: exits 2 instead of running something else than asked
REFUSED_OPTIONS = (
    "--workers", "--checkpoint-dir", "--resume", "--trace-out",
    "--metrics-out", "--lane-ledger-out", "--proof-log", "--persist-dir",
    "--rpc", "--rpctls", "-a", "--address", "--solv", "--solc-json",
    "-g", "--graph", "-j", "--statespace-json", "--enable-coverage-strategy",
    "--lockstep-dispatch", "--no-lockstep-dispatch", "--no-async-dispatch",
    "--device-force-dispatch", "--parallel-solving", "-q",
    "--query-signature",
)


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
        "--bin-runtime",
        action="store_true",
        help="Consider the input bytecode as binary runtime code, default "
        "being the contract creation bytecode.",
    )
    parser.add_argument(
        "solidity_files", nargs="*",
        help="Solidity inputs (refused: this build takes bytecode only)",
    )
    parser.add_argument(
        "-v", type=int, help="log level (0-5)", metavar="LOG_LEVEL",
        default=2, dest="verbosity",
    )


def _add_output_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "-o", "--outform",
        choices=["text", "markdown", "json", "jsonv2"],
        default="text",
        help="report output format",
        metavar="<text/markdown/json/jsonv2>",
    )


def create_analyzer_parser(parser: argparse.ArgumentParser) -> None:
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
        "--no-batched-solving", action="store_true",
        help="Disable the batched frontier feasibility path (per-state "
        "solving only)",
    )
    options.add_argument(
        "--no-onchain-data", action="store_true",
        help="Don't retrieve contract code, variables and balances from "
        "the blockchain (this build has no RPC client: always in effect)",
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
        "--enable-iprof", action="store_true",
        help="enable the instruction profiler",
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
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Where the dense tier runs: the card (default; an error "
        "without one) or, only when asked for, the CPU",
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python3 -m mythril_tpu_torch",
        description="Security analysis of Ethereum smart contracts "
        "(PyTorch/CUDA port)",
    )
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
    list_parser = subparsers.add_parser(
        "list-detectors", help="Lists available detection modules",
    )
    _add_output_args(list_parser)
    version_parser = subparsers.add_parser(
        "version", help="Outputs the version",
    )
    _add_output_args(version_parser)
    return parser


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
    elif args.solidity_files:
        address, _ = disassembler.load_from_solidity(args.solidity_files)
    else:
        exit_with_error(
            getattr(args, "outform", "text"),
            "No input bytecode. Please provide EVM code via -c BYTECODE "
            "or -f BYTECODE_FILE",
        )
    return address


def _refused(argv) -> list:
    return [
        arg for arg in argv
        if arg.split("=", 1)[0] in REFUSED_OPTIONS
    ]


def _analyze(disassembler, address, args) -> int:
    from mythril_tpu_torch.ops import default_device

    try:
        default_device(args.device)
    except RuntimeError as e:
        exit_with_error(args.outform, f"{e} (use --device cpu)", code=2)
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
    analyzer = MythrilAnalyzer(
        disassembler=disassembler,
        strategy=args.strategy,
        address=address,
        max_depth=args.max_depth,
        execution_timeout=args.execution_timeout,
        loop_bound=args.loop_bound,
        create_timeout=args.create_timeout,
        enable_iprof=args.enable_iprof,
        disable_dependency_pruning=args.disable_dependency_pruning,
        solver_timeout=args.solver_timeout,
        custom_modules_directory=args.custom_modules_directory or "",
        sparse_pruning=args.sparse_pruning,
        unconstrained_storage=args.unconstrained_storage,
        call_depth_limit=args.call_depth_limit,
        batched_solving=not args.no_batched_solving,
        device=args.device,
    )
    if not disassembler.contracts:
        exit_with_error(
            args.outform, "input files do not contain any valid contracts"
        )
    try:
        report = analyzer.fire_lasers(
            modules=[m.strip() for m in args.modules.strip().split(",")]
            if args.modules else None,
            transaction_count=args.transaction_count,
        )
    except DetectorNotFoundError as e:
        exit_with_error(args.outform, format(e))
    renderers = {
        "json": report.as_json,
        "jsonv2": report.as_swc_standard_format,
        "text": report.as_text,
        "markdown": report.as_markdown,
    }
    print(renderers[args.outform]())
    if report.exceptions:
        # the analysis salvaged what it could, but a failure (the dense
        # tier or its kernel among them) must not read as a clean run
        print("analysis failed:\n" + "\n".join(report.exceptions),
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    refused = _refused(argv)
    if refused:
        print(f"not supported by this build: {' '.join(refused)} "
              "(see ROADMAP.md)", file=sys.stderr)
        sys.exit(2)
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        sys.exit(2)

    if args.command == "version":
        version = mythril_tpu_torch.__version__
        if args.outform == "json":
            print(json.dumps({"version_str": version}))
        else:
            print(f"Mythril-TPU (PyTorch port) version {version}")
        sys.exit(0)

    # knobs are checked before any command runs, with the JAX CLI's
    # exit-2 contract: a typo'd value must not run a default, and a
    # value this build cannot honor must not run another solver
    from mythril_tpu_torch.ops.batched_sat import FRONTIER_OFF_REFUSED
    from mythril_tpu_torch.ops.frontier import frontier_enabled
    from mythril_tpu_torch.support.env import EnvSpecError, validate_env

    try:
        validate_env()
    except EnvSpecError as e:
        print(f"bad environment knob: {e}", file=sys.stderr)
        sys.exit(2)
    if not frontier_enabled():
        print(FRONTIER_OFF_REFUSED, file=sys.stderr)
        sys.exit(2)

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

    log_levels = [
        logging.NOTSET, logging.CRITICAL, logging.ERROR, logging.WARNING,
        logging.INFO, logging.DEBUG,
    ]
    level = log_levels[min(max(args.verbosity, 0), 5)]
    logging.basicConfig(
        level=level, format="%(name)s [%(levelname)s]: %(message)s"
    )
    logging.getLogger("mythril_tpu_torch").setLevel(level)

    outform = getattr(args, "outform", "text")
    try:
        disassembler = MythrilDisassembler()
        address = load_code(disassembler, args)
        if args.command in DISASSEMBLE_LIST:
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
