"""Requests as a deployment hands them to the bucketed servers, and the
same pairs laid out as those servers lay out a device batch, for the
reference.

The flagship's prompted layout: a prompt head of `offset` ids (the
beginning-of-sequence id first, the end-of-sequence id three before its
end, the mask id at the two mask positions that the prompt vectors
replace, seeded ids elsewhere), then the sentence. A sentence is the
beginning-of-sequence id, the mix's body ids, the end-of-sequence id.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.weights import sub_seed


def pick_bucket(length: int, buckets) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def prompt_head(seed: int, server: dict, tokens: dict, pool) -> np.ndarray:
    rng = np.random.default_rng(sub_seed(seed, "prompt"))
    off = server["offset"]
    head = pool[rng.integers(0, len(pool), off)].astype(np.int64)
    head[0], head[off - 3] = tokens["bos"], tokens["eos"]
    for m in server["mask_positions"]:
        head[m] = tokens["mask"]
    return head


def sentences(call: dict, tokens: dict) -> list:
    bos, eos = tokens["bos"], tokens["eos"]
    return [np.concatenate([[bos], body, [eos]]).astype(np.int64)
            for body in call["body"]]


def requests(family: str, call: dict, tokens: dict, head, fc, att) -> list:
    """The server's examples for one call: host token ids, device
    features (rows of `fc`, `att` and the call's CLIP features)."""
    out = []
    for i, ids in enumerate(sentences(call, tokens)):
        ex = {"visual_mean": fc[i], "visual_grid": att[i]}
        if family == "icka":
            ex.update(ori_input_ids=ids, input_ids=np.concatenate([head, ids]),
                      clip_features=call["clip"][i])
        else:
            ex["input_ids"] = ids
        out.append(ex)
    return out


def reference_batch(family: str, ids_list, b: int, tokens: dict, head,
                    num_regions: int, visual_mean, visual_grid, clip,
                    device) -> dict:
    """Pairs of bucket `b` padded as the bucketed server pads them (no
    repeated rows: rows are independent)."""
    n, pad = len(ids_list), tokens["pad"]
    lens = [min(len(x), b) for x in ids_list]

    def tensor(a):
        return torch.from_numpy(a).to(device)

    feats = {"img_mask": tensor(np.ones((n, num_regions), np.int64)),
             "visual_mean": visual_mean.float().to(device),
             "visual_grid": visual_grid.float().to(device)}
    if family == "gate_cl":
        ids = np.full((n, b), pad, np.int64)
        mask = np.zeros((n, b), np.int64)
        for r, (x, L) in enumerate(zip(ids_list, lens)):
            ids[r, :L], mask[r, :L] = x[:L], 1
        return dict(feats, input_ids=tensor(ids), input_mask=tensor(mask),
                    segment_ids=tensor(np.zeros((n, b), np.int64)))
    off = len(head)
    out = {
        "input_ids": np.full((n, off + b), pad, np.int64),
        "segment_ids": np.concatenate([np.zeros((n, off), np.int64),
                                       np.ones((n, b), np.int64)], 1),
        "input_mask": np.zeros((n, off + b), np.int64),
        "ori_input_ids": np.full((n, b), pad, np.int64),
        "ori_input_mask": np.zeros((n, b), np.int64),
        "ori_segment_ids": np.zeros((n, b), np.int64),
    }
    for r, (x, L) in enumerate(zip(ids_list, lens)):
        full = np.concatenate([head, x])
        out["input_ids"][r, :off + L] = full[:off + L]
        out["input_mask"][r, :off + L] = 1
        out["ori_input_ids"][r, :L] = x[:L]
        out["ori_input_mask"][r, :L] = 1
    out = {k: tensor(v) for k, v in out.items()}
    return dict(out, **feats, clip_features=clip.float().to(device)[:, None])
