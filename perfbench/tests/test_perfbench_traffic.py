"""The traffic generator: the same seed gives the same requests, and every
seed the same set of sizes in another order."""
import itertools
import json

import numpy as np

from perfbench import traffic
from perfbench.tests.conftest import ROOT


def _mix():
    return json.loads((ROOT / "perfbench/mixes/longprompt.json").read_text())


def _take(seed, n):
    return list(itertools.islice(traffic.requests(_mix(), 102400, seed), n))


def test_same_seed_same_requests():
    a, b = _take(2**31 + 7, 70), _take(2**31 + 7, 70)
    assert all(np.array_equal(p, q) and m == n for (p, m), (q, n) in zip(a, b))


def test_seeds_share_the_sizes_of_each_block():
    mix = _mix()
    a, b = _take(1, mix["block"]), _take(2, mix["block"])
    la, lb = [len(p) for p, _ in a], [len(p) for p, _ in b]
    assert la != lb and sorted(la) == sorted(lb)
    assert all(0 <= p.min() and p.max() < 102400 for p, _ in a)


def test_quantiles_stay_in_range():
    q = traffic.quantiles({"dist": "loguniform", "lo": 512, "hi": 2048}, 64)
    assert q.min() >= 512 and q.max() <= 2048 and np.all(np.diff(q) >= 0)
    assert traffic.quantiles({"dist": "fixed", "value": 16}, 3).tolist() == [16, 16, 16]
    u = traffic.quantiles({"dist": "uniform", "lo": 256, "hi": 1024}, 4)
    assert u.tolist() == [352, 544, 736, 928]
