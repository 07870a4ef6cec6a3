"""db-benchmark groupby q5 in plain torch: sum v1:v3 by id6."""

import torch

from qbench.plain import floats, group_sum, host, present

KEYS = ["id6"]
ORDER = None
LIMIT = None


def answer(tables, params, dtype):
    x = tables["x"]
    g = x["id6"].values.long()
    m = int(g.max()) + 1
    groups, _ = present(g, m)
    return {"id6": host(groups.to(x["id6"].values.dtype)),
            "v1": host(group_sum(g, x["v1"].values, m, torch.int64)[groups]),
            "v2": host(group_sum(g, x["v2"].values, m, torch.int64)[groups]),
            "v3": floats(group_sum(g, x["v3"].values, m, dtype)[groups])}
