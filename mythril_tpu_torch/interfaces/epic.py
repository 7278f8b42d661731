"""Rainbow output pager for ``--epic`` (own copy of
``mythril_tpu/interfaces/epic.py``; reference: mythril/interfaces/epic.py,
a lolcat-style colorizer).  Reads stdin,
writes ANSI-256 rainbow-colored text to stdout.  Pure cosmetics —
analysis output is piped through unchanged apart from color codes."""

import sys

# a smooth 256-color rainbow ramp (xterm color cube walk)
_RAMP = [
    196, 202, 208, 214, 220, 226, 190, 154, 118, 82, 46, 47, 48, 49,
    50, 51, 45, 39, 33, 27, 21, 57, 93, 129, 165, 201, 200, 199, 198,
    197,
]


def _color(index: int) -> int:
    return _RAMP[index % len(_RAMP)]


def colorize(text: str, freq: float = 0.3) -> str:
    """Diagonal rainbow: the hue advances along each line and down the
    file, giving the classic slanted-band look."""
    out_lines = []
    for row, line in enumerate(text.splitlines()):
        pieces = []
        for col, ch in enumerate(line):
            if ch.isspace():
                pieces.append(ch)
                continue
            phase = int(freq * col) + row
            pieces.append(f"\x1b[38;5;{_color(phase)}m{ch}")
        out_lines.append("".join(pieces) + "\x1b[0m")
    return "\n".join(out_lines)


def main() -> None:
    data = sys.stdin.read()
    if sys.stdout.isatty():
        sys.stdout.write(colorize(data) + "\n")
    else:
        sys.stdout.write(data)
    sys.stdout.flush()


if __name__ == "__main__":
    main()
