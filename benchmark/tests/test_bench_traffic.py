"""The traffic generator: requests are a function of the seed alone."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

from harness.traffic import Traffic  # noqa: E402


def _load(config, traffic):
    with open(BENCH / "configs" / f"{config}.json") as f:
        c = json.load(f)
    with open(BENCH / "traffic" / f"{traffic}.json") as f:
        t = json.load(f)
    return c, t


@pytest.mark.parametrize("config,traffic", [("pra_sto3g_huz", "scan"), ("nbed_water_mu", "scan"),
                                            ("pra_sto3g_huz", "sweep7"),
                                            ("pra_sto3g_huz", "fleet36")])
def test_same_seed_same_requests(config, traffic):
    c, t = _load(config, traffic)
    seed = 2 ** 31 + 12345  # the driver's seeds pass 32 signed bits
    a, b = Traffic(c, t, seed), Traffic(c, t, seed)
    other = Traffic(c, t, seed + 1)
    for i in range(9):
        ra, rb, ro = a.request("window", i), b.request("window", i), other.request("window", i)
        assert ra.geometries == rb.geometries
        assert ra.molecule["name"] == rb.molecule["name"]
        assert ra.geometries != ro.geometries
        assert len(ra.geometries) == t.get("batch", 1)
    # warm-up and window streams differ
    assert a.request("warmup", 0).geometries != a.request("window", 0).geometries


def test_jitter_is_the_traffic_sigma():
    c, t = _load("pra_sto3g_huz", "fleet36")
    gen = Traffic(c, t, 7)
    req = gen.request("window", 0)
    base = np.array([[float(v) for v in line.split()[1:4]]
                     for line in c["molecules"][0]["geometry"].strip().splitlines()[2:]])
    delta = req.coords_bohr - base[None] / 0.52917721092
    assert delta.shape == (36, 6, 3)
    assert abs(delta.std() - t["jitter_bohr"]) < 0.1 * t["jitter_bohr"]


def test_sweep_cycles_through_every_molecule_in_a_seeded_order():
    c, t = _load("pra_sto3g_huz", "sweep7")
    orders = set()
    for seed in (1, 99, 2 ** 33 + 5):
        gen = Traffic(c, t, seed)
        names = [gen.request("window", i).molecule["name"] for i in range(70)]
        first = names[:7]
        assert sorted(first) == sorted(m["name"] for m in c["molecules"])
        assert names == first * 10
        assert all(x != y for x, y in zip(names, names[1:]))
        # the warm-up pass runs the same order
        assert [gen.request("warmup", i).molecule["name"] for i in range(7)] == first
        orders.add(tuple(first))
    assert len(orders) > 1
