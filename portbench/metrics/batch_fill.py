"""batch_fill (serving, `serving/bucketed.py`): pairs served over the rows
the server dispatched (every device batch's rows, as the server's
protocol reports them from the `ServingStats` each `predict` returns), in
percent."""


def read(r):
    rows = sum(rows for c in r.calls for rows, _ in c["batches"])
    return 100.0 * r.pairs / rows if rows else None
