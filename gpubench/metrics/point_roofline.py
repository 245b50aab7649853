"""Share of their roofline of the point-smoothing calls
(``point_gs.gauss_seidel_point``), over the traced jobs."""
from ._roofline import share


def read(run):
    return share(run, 'point')
