"""db-benchmark groupby q4 in plain torch: mean v1:v3 by id4."""

from qbench.plain import floats, group_sum, host, present

KEYS = ["id4"]
ORDER = None
LIMIT = None


def answer(tables, params, dtype):
    x = tables["x"]
    g = x["id4"].values.long()
    m = int(g.max()) + 1
    groups, count = present(g, m)
    out = {"id4": host(groups.to(x["id4"].values.dtype))}
    for v in ("v1", "v2", "v3"):
        mean = group_sum(g, x[v].values, m, dtype) / count.to(dtype)
        out[v] = floats(mean[groups])
    return out
