"""Masked scatter: the port's counterpart of XLA's ``mode="drop"``.

XLA drops scatter writes whose index is out of bounds, and the JAX
package parks masked-out rows there on purpose.  Torch raises instead
(or trips a device assert), so masked writes go through here: rows whose
mask is False are redirected to the first masked-in row and write that
row's own value, so they change nothing and never race a real write.
No host sync: the decision stays on the device (and runs on fake
tensors, which have no values to read back).
"""
from __future__ import annotations

import torch


def masked_put_(dst: torch.Tensor, index: tuple, values, mask: torch.Tensor):
    """``dst[index] = values`` in place, for the rows where ``mask``.

    ``index`` is a tuple of (N,) index tensors (one per leading dim of
    ``dst`` it addresses); ``values`` broadcasts to (N, *rest).  Rows
    with mask False may carry any index, in bounds or not.  Masked-in
    rows must not collide with each other unless they write equal
    values (as with XLA, the winner of a collision is unspecified).
    """
    n = mask.shape[0]
    any_ = mask.any()
    # first masked-in row, or 0; a (1,) index (a 0-d one reads its value
    # back to the host)
    j0 = mask.to(torch.uint8).argmax().reshape(1)
    idx = []
    fallback = []
    for i in index:
        i = i.to(torch.int64).expand(n)
        fb = torch.where(any_, i[j0], 0)
        fallback.append(fb)
        idx.append(torch.where(mask, i, fb))
    rest = dst.shape[len(index):]
    values = torch.as_tensor(values, dtype=dst.dtype, device=dst.device)
    values = values.expand(n, *rest)
    # no row masked in: every row writes dst[0, ...] back to itself
    fb_val = torch.where(any_, values[j0], dst[tuple(fallback)])
    m = mask.reshape(n, *([1] * len(rest)))
    dst.index_put_(tuple(idx), torch.where(m, values, fb_val))
    return dst
