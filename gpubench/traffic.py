"""The one traffic generator: what changes from job to job, drawn from
the seed.

A workload file's ``traffic`` lists named draws, each ``{"low", "high",
"scale": "linear" | "log", "size"}``.  Over ``STRATA`` jobs every draw
takes each of ``STRATA`` equal slices of its range once, in an order
the seed permutes, at a point inside the slice drawn from (seed, job):
every run does the same amount of work whatever its seed, and no two
jobs see the same value, so nothing can be served from a cache keyed on
the input.  The warm-up job takes the middle of every range.
"""
import numpy as np

__all__ = ['Traffic']

STRATA = 16


class Traffic:
    def __init__(self, spec, seed):
        self.draws = dict(spec)
        self.seed = int(seed)
        self._perm = {name: np.random.default_rng(
            [self.seed, 1, i]).permutation(STRATA)
            for i, name in enumerate(sorted(self.draws))}

    def _value(self, d, u):
        lo, hi = float(d['low']), float(d['high'])
        if d.get('scale', 'linear') == 'log':
            return float(10 ** (np.log10(lo) + u * (np.log10(hi)
                                                      - np.log10(lo))))
        return float(lo + u * (hi - lo))

    def warmup(self):
        """The draws of the warm-up job: the middle of each range."""
        return {name: [self._value(d, 0.5)] * int(d.get('size', 1))
                for name, d in self.draws.items()}

    def job(self, j):
        """The draws of timed job ``j`` (0, 1, ...)."""
        out = {}
        for i, (name, d) in enumerate(sorted(self.draws.items())):
            rng = np.random.default_rng([self.seed, 2, i, int(j)])
            size = int(d.get('size', 1))
            # Each component of a vector draw takes its own slice order.
            slices = [self._perm[name][(j + 5 * c) % STRATA]
                      for c in range(size)]
            out[name] = [self._value(d, (s + rng.uniform()) / STRATA)
                         for s in slices]
        return out
