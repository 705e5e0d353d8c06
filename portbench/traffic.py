"""The one traffic generator: reads a mix's parameters
(`portbench/traffic/<name>.json`) and makes each call's pairs from the
run's seed. A new mix is a new parameter file; this module needs no edit.

A mix is a closed loop of one client sending calls of (sentence, image)
pairs. Its parameters:

  - "pairs_per_call": a whole number, or {"min", "max"} for calls whose
    sizes spread evenly over that range;
  - "cycle" (default 8): the number of calls that together hold the mix's
    fixed work (see below);
  - "lengths": the sentence lengths in subtokens with the two boundary
    tokens, one of
      "lognormal": int(exp(ln(median) + sigma * z) + add), clipped to
        [min, max];
      "uniform": every length from min to max equally often;
      "table": {"lengths": [...], "weights": [...]}, any histogram, for a
        shape taken from a published length table;
  - "image_size": the side of the square uint8 images;
  - "image_reuse" (default 0): the share of a call's pairs whose image
    (and CLIP features) repeat an earlier pair's of the same call.

Every cycle of calls holds the same work: the call sizes are the size
distribution's quantiles at (i + 0.5) / cycle, the lengths the length
distribution's quantiles over all the cycle's pairs. The seed shuffles
the sizes into an order and the lengths over the cycle's calls, anew in
every cycle, so that each call's mix of lengths differs while seeds
change which pairs are sent and not how much work they are. Token ids are
drawn uniformly from [low, vocab) minus the configuration's special ids;
images are uint8 noise; CLIP features are standard normals. Each call's
draws come from generators seeded with (seed, call index), the images and
CLIP features on the device, so no pair repeats within a run (but for
`image_reuse`) and no two runs of one seed differ.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np
import torch

from portbench.weights import sub_seed


def load(path: Path) -> dict:
    spec = json.loads(Path(path).read_text())
    for key in ("pairs_per_call", "lengths", "image_size"):
        if key not in spec:
            raise SystemExit(f"{path}: traffic mix lacks {key!r}")
    if not 0 <= spec.get("image_reuse", 0) < 1:
        raise SystemExit(f"{path}: image_reuse must lie in [0, 1)")
    return spec


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def call_sizes(spec: dict) -> np.ndarray:
    """The sizes of one cycle's calls, ascending."""
    cycle, per = spec.get("cycle", 8), spec["pairs_per_call"]
    if isinstance(per, int):
        return np.full(cycle, per, np.int64)
    lo, hi = per["min"], per["max"]
    return (lo + np.floor(_quantiles(cycle) * (hi - lo + 1))).astype(np.int64)


def lengths_at(ln: dict, q: np.ndarray) -> np.ndarray:
    """The length distribution `ln` at the quantiles `q`."""
    if ln["kind"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        lens = np.exp(math.log(ln["median"]) + ln["sigma"] * z) + ln["add"]
    elif ln["kind"] == "uniform":
        lens = ln["min"] + np.floor(q * (ln["max"] - ln["min"] + 1))
    elif ln["kind"] == "table":
        values = np.asarray(ln["lengths"], np.int64)
        cdf = np.cumsum(np.asarray(ln["weights"], np.float64))
        lens = values[np.minimum(np.searchsorted(cdf / cdf[-1], q),
                                 len(values) - 1)]
    else:
        raise SystemExit(f"unknown length distribution {ln['kind']!r}")
    lo = ln.get("min", 1)
    hi = ln.get("max", int(np.max(lens)))
    return np.clip(lens.astype(np.int64), lo, hi)


def cycle_lengths(spec: dict) -> np.ndarray:
    """The multiset of lengths every cycle of calls holds, ascending."""
    n = int(call_sizes(spec).sum())
    return lengths_at(spec["lengths"], _quantiles(n))


def length_range(spec: dict) -> tuple[int, int]:
    lens = cycle_lengths(spec)
    return int(lens.min()), int(lens.max())


class Traffic:
    """Calls of one mix for one run: `call(k)` gives call k's pairs."""

    def __init__(self, spec: dict, seed: int, tokens: dict, vocab: int,
                 clip_dim: int | None, device):
        self.spec, self.seed, self.device = spec, seed, device
        self.sizes = call_sizes(spec)
        self.lengths = cycle_lengths(spec)
        self.reuse = spec.get("image_reuse", 0)
        self.tokens, self.vocab, self.clip_dim = tokens, vocab, clip_dim
        special = {tokens[k] for k in ("bos", "eos", "pad", "mask")
                   if k in tokens}
        pool = np.arange(tokens["low"], vocab)
        self.pool = pool[~np.isin(pool, sorted(special))]
        self._cycle = (None, None)

    def _cycle_of(self, c: int):
        """(sizes in call order, lengths shuffled) of cycle `c`."""
        if self._cycle[0] != c:
            rng = np.random.default_rng(sub_seed(self.seed, f"cycle{c}"))
            self._cycle = (c, (rng.permutation(self.sizes),
                               rng.permutation(self.lengths)))
        return self._cycle[1]

    def lengths_of(self, k: int) -> np.ndarray:
        """Call k's lengths."""
        c, p = divmod(k, len(self.sizes))
        sizes, lens = self._cycle_of(c)
        start = int(sizes[:p].sum())
        return lens[start:start + int(sizes[p])]

    def call(self, k: int, lengths=None) -> dict:
        """{"lengths": (n,), "body": [n int64 arrays of L - 2 ids],
        "images": uint8 (n, S, S, 3) on the device, "clip": (n, C) or
        None}. `lengths` replaces the mix's (the warm-up's shapes)."""
        lens = (self.lengths_of(k) if lengths is None
                else np.asarray(lengths, np.int64))
        n = len(lens)
        rng = np.random.default_rng(sub_seed(self.seed, f"call{k}"))
        body = [self.pool[rng.integers(0, len(self.pool), int(L) - 2)]
                for L in lens]
        gen = torch.Generator(device=self.device).manual_seed(
            sub_seed(self.seed, f"images{k}"))
        S = self.spec["image_size"]
        images = torch.randint(0, 256, (n, S, S, 3), generator=gen,
                               device=self.device, dtype=torch.uint8)
        clip = (None if self.clip_dim is None else
                torch.randn(n, self.clip_dim, generator=gen,
                            device=self.device))
        src = self._image_sources(rng, n)
        if src is not None:
            index = torch.from_numpy(src).to(self.device)
            images = images[index]
            clip = None if clip is None else clip[index]
        return {"lengths": lens, "body": body, "images": images,
                "clip": clip}

    def _image_sources(self, rng, n: int):
        """Each pair's image index: a share `image_reuse` of the pairs
        (never the first) take an earlier pair's image; None when no pair
        does."""
        m = int(round(self.reuse * n))
        if not m or n < 2:
            return None
        src = np.arange(n)
        for i in np.sort(rng.choice(np.arange(1, n), min(m, n - 1),
                                    replace=False)):
            src[i] = src[rng.integers(0, i)]
        return src
