"""Terminal coloring (reference: `gym/utils/colorize.py` †)."""

color2num = dict(
    gray=30, red=31, green=32, yellow=33, blue=34, magenta=35, cyan=36,
    white=37, crimson=38,
)


def colorize(string, color, bold=False, highlight=False):
    """Colorize a string for ANSI terminals."""
    attr = []
    num = color2num[color]
    if highlight:
        num += 10
    attr.append(str(num))
    if bold:
        attr.append("1")
    return "\x1b[{}m{}\x1b[0m".format(";".join(attr), string)
