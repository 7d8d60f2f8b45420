"""Static device cost model for the verify kernels.

For each device-pass shape (mode, window, bucket) the kernel's dominant
resource draws are an analytic function of the geometry —

- **table-row gathers**: the fused engine gathers ONE packed Niels row
  per window position per item (the (s_nibble, k_nibble) pair indexes
  a joint table), the split comb engine gathers TWO (separate base- and
  A-tables), the ladder gathers none. Row bytes come from
  ``ops/comb.ROW`` so ``use_row_packing`` (128 B rows) is honored
  automatically.
- **madds**: one mixed Edwards add per gathered row — w=5 is 52/item.
- **host->device wire bytes**: what the staging path actually ships
  per item (the fused WIRE layout is ~101 B/item; comb re-ships
  window-decomposed scalars).

Joined with the device ledger's measured per-shape dispatch counts,
these constants give achieved-vs-peak gather bandwidth and a
dominant-limiter verdict.

Reference peaks are MEASURED operating ceilings, not datasheet
numbers: ``h100`` is the card's memory read rate, the bytes that
``torch.sum`` reads from a 2 GiB int32 tensor (far past the 50 MB L2
cache) over the median of 20 calls between CUDA events
(``chip_smoke.py`` ``read_probe``, phase ``costmodel``). A gather reads
each distinct table row from device memory at least once, so a pass's
distinct rows over its time cannot pass this ceiling; rows a batch
repeats (a key's rows are shared by its signatures) come from the L2
cache, so a rate of all rows gathered can. The rate of a gather by
``torch.index_select`` is a measurement of its own (the same phase), not
the ceiling. On a CPU backend no peak is meaningful and callers get
``None``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..ops import comb

# measured gather-bandwidth ceilings by platform key (GB/s).
# h100: chip_smoke.py read_probe (phase costmodel) on "NVIDIA H100 80GB
# HBM3, 700.00 W": 2,147,483,648 B read by torch.sum over the median
# call, 0.7229119837284088 ms, 2970.6018 GB/s.
PEAK_GATHER_GBPS: Dict[str, float] = {"h100": 2970.6}

# rough int-op cost of one mixed Edwards add on 17-limb field elements
# (~8 field muls of 17x17 limb products, mul+add each): used only for
# arithmetic-intensity context, never for a pass/fail verdict.
MADD_INT_OPS = 8 * 17 * 17 * 2


def shape_cost(
    mode: str, window: int, bucket: int, row_bytes: Optional[int] = None
) -> Dict[str, Any]:
    """Per-item and per-pass analytic costs for one device-pass shape.

    ``mode`` is the ledger's spelling (``fused``/``wire``/``comb``/
    ``ladder``/arbitrary lane modes); unknown modes return a zero-gather
    row (pairing lanes, shard wrappers) so callers can sum blindly.
    ``row_bytes`` overrides the live ``comb.ROW`` width (post-hoc
    analysis of a packed-row run from an unpacked process).
    """
    rb = (comb.ROW * 4) if row_bytes is None else int(row_bytes)
    m = mode.split("/")[0]
    if m.startswith("wire") or m.startswith("fused"):
        npos = comb.npos_for(window if window else 4)
        gathers = npos  # joint (s, k) window: one fused-table row/pos
        wire = 96 + 4 + 1  # S||k||R + a_idx + precheck per item
    elif m == "comb":
        npos = comb.NPOS
        gathers = 2 * npos  # separate base-table and A-table rows
        wire = 2 * npos * 4 + 4 + 17 * 4 + 4 + 1  # s/k windows + idx + R
    elif m == "ladder":
        npos = 256
        gathers = 0  # no key cache: the ladder recomputes, gathers nothing
        wire = 2 * 256 * 4 + 4 * (17 * 2 + 2) + 1  # bit arrays + points
    else:
        return {
            "mode": mode, "window": window, "bucket": bucket,
            "gathers_per_item": 0, "row_bytes": rb,
            "gather_bytes_per_item": 0, "gather_bytes_per_pass": 0,
            "madds_per_item": 0, "flops_per_item": 0,
            "wire_bytes_per_item": 0,
        }
    gb_item = gathers * rb
    madds = max(gathers, npos)
    return {
        "mode": mode,
        "window": window,
        "bucket": bucket,
        "gathers_per_item": gathers,
        "row_bytes": rb,
        "gather_bytes_per_item": gb_item,
        "gather_bytes_per_pass": gb_item * bucket,
        "madds_per_item": madds,
        "flops_per_item": madds * MADD_INT_OPS,
        "wire_bytes_per_item": wire,
    }


def parse_shape_key(key: str) -> Optional[Dict[str, Any]]:
    """``"ed25519:fused/w4/b8192"`` (the device ledger's lane-qualified
    shapes key; a bare ``"fused/w4/b8192"`` parses too) ->
    {"lane": ..., "mode": ..., "window": ..., "bucket": ...}; None if
    malformed."""
    try:
        lane, _, rest = key.rpartition(":")
        mode, w, b = rest.split("/")
        if not (w.startswith("w") and b.startswith("b")):
            return None
        return {"lane": lane, "mode": mode,
                "window": int(w[1:]), "bucket": int(b[1:])}
    except (ValueError, AttributeError):
        return None


def gather_bytes_for_shapes(shapes: Dict[str, Dict[str, int]]) -> int:
    """Total analytic table-gather bytes implied by a device-ledger
    ``shapes`` block (each row carries dispatches/items; gathers cover
    the PADDED bucket — pad rows gather garbage but still burn
    bandwidth, which is exactly why pad waste is a ledger column)."""
    total = 0
    for key, row in shapes.items():
        parsed = parse_shape_key(key)
        if parsed is None:
            continue
        cost = shape_cost(parsed["mode"], parsed["window"], parsed["bucket"])
        total += cost["gather_bytes_per_pass"] * int(row.get("dispatches", 0))
    return total
