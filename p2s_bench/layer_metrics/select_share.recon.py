"""select_share.recon (%): the share of the device's busy time that the
window's ``torch.topk`` calls take (the tile candidates, the tiles' and the
dense path's top-k, the sub-sample's top-S): the device seconds of the
kernels ``torch.topk`` launches, by name in the trace, over the union of
all operations' intervals.

The names were read from a trace of each ``torch.topk`` shape of the recon
path timed alone on an H100 (PyTorch 2.11), and checked against a
``--trace 1`` breakdown of ``p2s_large_kNN.recon``:

* the radix selection: every kernel in ``at::native::mbtopk::`` (digit
  counts, digit cum-sum, within-k and k-th counts, ``gatherTopK``,
  ``fill``, and cub's scan-by-key over ``mbtopk::BlockIdxToKey``), and the
  single-block ``at::native::sbtopk::gatherTopK`` of small slices;
* the sort of the k selected values by their float keys: in place up to
  4,096 values (``radixSortKVInPlace<..., float, long, ...>``; any
  ``*SortKVInPlace`` of float keys counts), and above that (the tiles'
  8,192 candidates) cub's radix sort over float keys
  (``DeviceRadixSortPolicy<float, ...>``).

Left out, as other ops launch them too: the Morton order's ``argsort``
sorts int keys in place (``radixSortKVInPlace<..., int, long, ...>``), the
long-key cub sorts (index bookkeeping, ``index_put_``), memsets and copies.
"""

import devtrace

SELECT = ("mbtopk::", "sbtopk::")
SORT = ("SortKVInPlace<", "DeviceRadixSort")
FLOAT_KEYS = (", float, long,", "DeviceRadixSortPolicy<float,")


def _is_topk(name: str) -> bool:
    return any(s in name for s in SELECT) or (
        any(s in name for s in SORT) and any(k in name for k in FLOAT_KEYS))


def read(ctx):
    topk = [e for e in ctx.events if _is_topk(e[0])]
    select_s = devtrace.op_seconds(topk, *SELECT, *SORT)
    if select_s <= 0.0 or ctx.busy_s <= 0.0:
        return None
    return 100.0 * select_s / ctx.busy_s
