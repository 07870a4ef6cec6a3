"""db-benchmark groupby q3 in plain torch: sum v1, mean v3 by id3."""

import torch

from qbench.plain import (dict_size, dict_strings, floats, group_sum, host,
                          present)

KEYS = ["id3"]
ORDER = None
LIMIT = None


def answer(tables, params, dtype):
    x = tables["x"]
    g = x["id3"].values.long()
    m = dict_size(x["id3"])
    groups, count = present(g, m)
    v3 = group_sum(g, x["v3"].values, m, dtype) / count.to(dtype)
    return {"id3": dict_strings(x["id3"], groups),
            "v1": host(group_sum(g, x["v1"].values, m, torch.int64)[groups]),
            "v3": floats(v3[groups])}
