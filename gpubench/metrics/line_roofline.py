"""Share of their roofline of the line-relaxation calls
(``line_gs.line_relaxation``), over the traced jobs."""
from ._roofline import share


def read(run):
    return share(run, 'line')
