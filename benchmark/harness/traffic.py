"""The one traffic generator: a traffic file's parameters and a
configuration's molecules in, a deterministic stream of requests out.

Parameters read from the traffic file:
- ``molecules``: "first" (the configuration's first molecule) or "all";
- ``order``: "repeat" (the molecules in the file's order, in turn) or
  "cycle" (the molecules in one order drawn from the seed, in turn: no
  molecule twice in a row, and every seed revisits each structure after
  the same number of others, so the program's caches see the same work);
- ``jitter_bohr``: sigma of the Gaussian added to every coordinate;
- ``batch``: geometries per request (1 where absent).

Request ``i`` of a stream is a function of (seed, stream, i) alone, so two
runs with one seed send the same geometries in the same order, and every
seed sends the same molecules in the same proportions.
"""

from dataclasses import dataclass

import numpy as np

__all__ = ["Request", "Traffic", "BOHR_IN_ANGSTROM"]

BOHR_IN_ANGSTROM = 0.52917721092
_STREAMS = {"warmup": 1, "window": 2}


@dataclass
class Request:
    index: int
    stream: str
    molecule: dict
    geometries: list      # XYZ texts in angstrom, one per conformer
    coords_bohr: np.ndarray  # (batch, natm, 3)


def _parse(xyz: str):
    lines = xyz.strip("\n").splitlines()
    natm = int(lines[0].split()[0])
    symbols, coords = [], []
    for line in lines[2:2 + natm]:
        parts = line.split()
        symbols.append(parts[0])
        coords.append([float(v) for v in parts[1:4]])
    return symbols, np.array(coords)


def _format(symbols, coords_angstrom) -> str:
    rows = [f"{s} {x:.12f} {y:.12f} {z:.12f}" for s, (x, y, z) in zip(symbols, coords_angstrom)]
    return "\n".join([str(len(symbols)), ""] + rows) + "\n"


class Traffic:
    def __init__(self, config: dict, traffic: dict, seed: int):
        mols = config["molecules"]
        self.molecules = mols[:1] if traffic["molecules"] == "first" else list(mols)
        self.order = traffic["order"]
        self.sigma = float(traffic["jitter_bohr"])
        self.batch = int(traffic.get("batch", 1))
        self.seed = int(seed) % 2 ** 64
        self._parsed = [_parse(m["geometry"]) for m in self.molecules]
        self._cycle = self._rng(0).permutation(len(self.molecules))

    def _rng(self, *keys):
        return np.random.default_rng([self.seed, *keys])

    def molecule_index(self, stream: str, index: int) -> int:
        n = len(self.molecules)
        if self.order == "repeat":
            return index % n
        if self.order == "cycle":
            return int(self._cycle[index % n])
        raise ValueError(f"unknown order {self.order!r}")

    def request(self, stream: str, index: int) -> Request:
        k = self.molecule_index(stream, index)
        symbols, coords = self._parsed[k]
        noise = self._rng(_STREAMS[stream], 1, index).standard_normal(
            (self.batch,) + coords.shape)
        bohr = coords[None] / BOHR_IN_ANGSTROM + self.sigma * noise
        texts = [_format(symbols, c * BOHR_IN_ANGSTROM) for c in bohr]
        # the coordinates exactly as the texts give them
        bohr = np.stack([_parse(t)[1] for t in texts]) / BOHR_IN_ANGSTROM
        return Request(index, stream, self.molecules[k], texts, bohr)
