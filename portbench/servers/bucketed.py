"""The bucketed servers' protocol (`serving/bucketed.py`): how the harness
sees which device batch and row served each pair, the rows and padded
length of each device batch a call ran, and how the reference lays the
same pairs out. A configuration names its protocol in `server.protocol`;
a server of another protocol (such as the packed servers) brings a file of
its own beside this one.

Each device batch holds the pairs of one bucket, padded to the bucket's
length, in as many rows as the server's batch for that bucket (a short
batch repeats rows to fill it).
"""

from __future__ import annotations

import torch

from portbench import layout
from portbench.reference import text as ref_text


def attach(system) -> None:
    """Record each call's device batches, as (bucket, example indices),
    in `system.batches`."""
    served = system.server.batches

    def recorded(examples):
        for b, chunk, lens, batch in served(examples):
            system.batches.append((b, list(chunk)))
            yield b, chunk, lens, batch

    system.server.batches = recorded


def rows_of(server, bucket: int) -> int:
    """Rows the server dispatches in one batch of `bucket`."""
    return server._batch_of(bucket) if hasattr(server, "_batch_of") \
        else server.max_batch


def device_batches(server, stats) -> list:
    """[(rows, padded length)] of every device batch of one call."""
    return [(rows_of(server, b), b)
            for b, n in sorted(stats.batches_per_bucket.items())
            for _ in range(n)]


def served_rows(system) -> dict:
    """{example index: (its row of the emissions, (bucket, T); bucket)}
    of the call just served."""
    out = {}
    for j, (b, chunk) in enumerate(system.batches):
        for r, i in enumerate(chunk):
            out[i] = (system.emissions[j][r], b)
    return out


def warm_lengths(buckets, lo: int, hi: int) -> list:
    """One length in each bucket that lengths in [lo, hi] reach."""
    reach = sorted({layout.pick_bucket(L, buckets)
                    for L in range(lo, hi + 1)})
    return [max(lo, min(b, hi)) for b in reach]


def reference_emissions(ref, recs, pooled, grid) -> list:
    """Per record, the reference's emissions (L, T) on the reference's
    visual features, each bucket's records as one batch laid out as the
    server lays out that bucket."""
    cfg = ref.cfg
    fam, m, srv = cfg["family"], cfg["model"], cfg["server"]
    out = [None] * len(recs)
    for b in sorted({r["bucket"] for r in recs}):
        idx = [i for i, r in enumerate(recs) if r["bucket"] == b]
        clip = (torch.stack([recs[i]["clip"] for i in idx])
                if fam == "icka" else None)
        batch = layout.reference_batch(
            fam, [recs[i]["ids"] for i in idx], b, cfg["tokens"], ref.head,
            m["num_regions"], pooled[idx], grid[idx], clip, ref.device)
        with torch.no_grad():
            if fam == "icka":
                em = ref_text.icka_emissions(
                    ref.text_sd, m, batch, srv["offset"],
                    tuple(srv["mask_positions"]), ref.prec)
            else:
                em = ref_text.gate_cl_emissions(ref.text_sd, m, batch,
                                                ref.prec)
        for r, i in enumerate(idx):
            out[i] = em[r, :recs[i]["length"]].cpu()
    return out
