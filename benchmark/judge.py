"""What decides ``correct``: records of the program against the plain
reference, and the helpers every driver shares.

The comparison is exact.  A record is (hash, start, end, rev) at its
offset; ``mismatched`` counts the records of one sequence that differ, a
record present on one side only included.  The limits are those of an
exact comparison: no mismatched record, and at least one record compared.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .reference import kminmers as reference

FIELDS = ("hash", "start", "end", "rev")
# The control: the reference at the next lower minimizer hash width than
# the configuration states.
LOWER_WIDTH = {64: 32, 32: 16}


def spec_args(config: dict) -> dict:
    """The configuration's k-min-mer parameters, as the program's
    ``PipelineSpec`` takes them."""
    s = config["spec"]
    return {"l": s["l"], "k": s["k"], "density": s["density"], "mode": s["mode"],
            "hash_width": s["hash_width"], "variant": s["variant"]}


def expected(seq: np.ndarray, config: dict, xcodes: bool = False,
             control: bool = False) -> dict:
    """The reference's records of one sequence; with ``control``, those of
    the reference at the next lower hash width."""
    s = config["spec"]
    if s["variant"] != "nthash1":
        raise ValueError("the reference computes nthash1 only")
    width = LOWER_WIDTH[s["hash_width"]] if control else s["hash_width"]
    return reference.kminmers(seq, s["l"], s["k"], s["density"], s["mode"], width, xcodes)


def mismatched(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> int:
    """Records that differ between two record sets of one sequence."""
    n_got, n_want = len(got["hash"]), len(want["hash"])
    n = min(n_got, n_want)
    differ = np.zeros(n, dtype=bool)
    for f in FIELDS:
        differ |= np.asarray(got[f][:n]).astype(np.uint64) != np.asarray(
            want[f][:n]).astype(np.uint64)
    return int(differ.sum()) + abs(n_got - n_want)


def checks(mismatches: int, compared: int) -> dict:
    """The numbers compared, each with its limit."""
    return {
        "mismatched_records": {"value": mismatches, "limit": 0, "rule": "<=",
                               "ok": mismatches <= 0},
        "compared_records": {"value": compared, "limit": 1, "rule": ">=",
                             "ok": compared >= 1},
    }


class Reservoir:
    """A seeded uniform sample of ``size`` items of a stream whose length is
    not known ahead (algorithm R)."""

    def __init__(self, rng: np.random.Generator, size: int):
        self.rng, self.size, self.seen, self.items = rng, size, 0, []

    def offer(self, make) -> bool:
        """Consider the stream's next item; ``make()`` builds it only when
        it is kept -> whether it was."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
            return True
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.items[j] = make()
            return True
        return False
