"""Seekable TSV dataset files with sidecar line index (a copy of
`icka_tpu.utils.tsv_file`).

Rebuild of `utils/tsv_file.py:20-85` / `utils/tsv_file_ops.py`: random access
into large TSV datasets via a `.lineidx` file of byte offsets. Used by the
VCR/captioning data path; kept dependency-free."""

from __future__ import annotations

import os
from typing import List, Optional


def _lineidx_path(tsv_path: str) -> str:
    return os.path.splitext(tsv_path)[0] + ".lineidx"


def build_lineidx(tsv_path: str, idx_path: Optional[str] = None) -> str:
    idx_path = idx_path or _lineidx_path(tsv_path)
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = 0
        for line in f:
            offsets.append(pos)
            pos += len(line)
    with open(idx_path, "w") as f:
        for off in offsets:
            f.write(f"{off}\n")
    return idx_path


class TSVFile:
    """Random-access rows of a TSV file; builds the line index on demand."""

    def __init__(self, tsv_path: str, generate_lineidx: bool = True):
        self.tsv_path = tsv_path
        self.lineidx_path = _lineidx_path(tsv_path)
        self._fp = None
        self._lineidx: Optional[List[int]] = None
        if not os.path.isfile(self.lineidx_path) and generate_lineidx:
            build_lineidx(tsv_path, self.lineidx_path)

    def _ensure(self):
        if self._lineidx is None:
            with open(self.lineidx_path) as f:
                self._lineidx = [int(l) for l in f if l.strip()]
        if self._fp is None:
            self._fp = open(self.tsv_path, "r")

    def num_rows(self) -> int:
        self._ensure()
        return len(self._lineidx)

    def __len__(self):
        return self.num_rows()

    def seek(self, idx: int) -> List[str]:
        self._ensure()
        self._fp.seek(self._lineidx[idx])
        return [s.strip() for s in self._fp.readline().split("\t")]

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)

    def close(self):
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def tsv_writer(rows, tsv_path: str):
    """Write rows (iterables of str) + line index in one pass
    (`utils/tsv_file_ops.py` equivalent)."""
    idx_path = _lineidx_path(tsv_path)
    with open(tsv_path, "w") as f, open(idx_path, "w") as fidx:
        pos = 0
        for row in rows:
            line = "\t".join(str(c) for c in row) + "\n"
            f.write(line)
            fidx.write(f"{pos}\n")
            pos += len(line.encode("utf-8"))


def load_list_file(path: str) -> List[str]:
    """One stripped string per line, trailing blank dropped
    (`utils/tsv_file_ops.py:50-57`)."""
    with open(path) as f:
        lines = [line.strip() for line in f]
    if lines and lines[-1] == "":
        lines.pop()
    return lines


def concat_tsv_files(tsvs: List[str], out_tsv: str,
                     generate_lineidx: bool = False) -> None:
    """Byte-concatenate TSV shards; optionally merge their .lineidx files
    by offsetting each shard's entries by the cumulative byte size of the
    preceding shards (`utils/tsv_file_ops.py:34-47`). Writes through a .tmp
    then renames, so a crashed concat never leaves a torn output."""
    import shutil

    tmp = out_tsv + ".tmp"
    with open(tmp, "wb") as out:
        for t in tsvs:
            with open(t, "rb") as f:
                shutil.copyfileobj(f, out, 10 * 1024 * 1024)
    os.rename(tmp, out_tsv)
    if generate_lineidx:
        offset = 0
        with open(_lineidx_path(out_tsv), "w") as f:
            for t in tsvs:
                for idx in load_list_file(_lineidx_path(t)):
                    f.write(f"{int(idx) + offset}\n")
                offset += os.stat(t).st_size


def reorder_tsv_keys(in_tsv: str, ordered_keys: List[str],
                     out_tsv: str) -> None:
    """Rewrite a key-first TSV with rows in `ordered_keys` order
    (`utils/tsv_file_ops.py:59-68`)."""
    tsv = TSVFile(in_tsv, generate_lineidx=True)
    key_to_idx = {tsv.seek(i)[0]: i for i in range(len(tsv))}
    tsv_writer((tsv.seek(key_to_idx[k]) for k in ordered_keys), out_tsv)
    tsv.close()


def delete_tsv_files(tsvs: List[str]) -> None:
    """Remove TSV shards and their .lineidx sidecars, ignoring races
    (`utils/tsv_file_ops.py:70-92`)."""
    for t in tsvs:
        for path in (t, _lineidx_path(t)):
            try:
                os.remove(path)
            except OSError:
                pass
