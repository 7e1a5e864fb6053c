"""The least work of the port's sweeps: the yardstick of the kernel rooflines.

A frozen copy of ``chip_smoke.py``'s ``sweep_work``, ``finish_work``,
``bound`` and ``step_bound_ms`` (the bytes model behind PERF.md's bounds).
The benchmark owns it, not the program: a change to the program cannot
move the bound its kernels are held to. Each input byte is counted read
once and each output byte written once, whatever a kernel reads again:
these are the bytes the algorithm needs for these inputs, whatever kernel
implements them.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W power
limit: HBM bytes/s and f32 FLOP/s outside the tensor cores.
"""

from __future__ import annotations

import math
import re

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Potentials whose B the port's sweeps work out from coordinates; every
# other potential's B (file, script, FullCornell and its complex form)
# streams from memory and is counted once a launch.
B_FROM_COORDINATES = frozenset({
    "NoPotential", "Harmonic", "Coulomb", "SimpleCornell", "Periodic",
    "ComplexHarmonic", "ComplexCoulomb",
})


def bound(work):
    """(bound_s, bound_by) of ``work`` = (bytes, flops): the larger of the
    bytes over the HBM rate and the operations over the f32 peak."""
    t_bytes = work[0] / HBM_BYTES_PER_S
    t_ops = work[1] / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_work(n, ext, n_store=0, streamed=False, reduce=False, pair=False, stream_bytes=4):
    """(bytes, flops) of the least work one K1 (``pair``: K3) sweep of an
    ``n`` interior does: ψ read and ψ' written once over the padded volume,
    B read once where it streams, each stored state read once over the
    padded volume at ``stream_bytes`` a value (2 for bf16 stores); per
    interior point the stencil, B from coordinates where it does not
    stream, and the update; where the sweep reduces, the correction once a
    padded point and the reductions once an interior point."""
    comps = 2 if pair else 1
    padded = math.prod(d + 2 * ext for d in n)
    interior = math.prod(n)
    nbytes = (4 * comps * padded * 2 + stream_bytes * comps * padded * n_store
              + 4 * comps * interior * streamed)
    flops = (comps * (1 + 9 * ext + 5) + (0 if streamed else 14 * comps)) * interior
    if reduce:
        correction = comps + (8 if pair else 2) * n_store
        sums = (4 + 8 * n_store) if pair else 2 * (1 + n_store)
        flops += correction * padded + sums * interior
    return nbytes, flops


def finish_work(n_rows, n_red):
    """(bytes, flops) of one K2 launch: the partial rows read once, the
    sums and coefficients written."""
    return 8 * n_rows * n_red + 12 * n_red, n_rows * n_red


def step_bound_ms(n, n_store=0, streamed=False, reduce=False, pair=False, rows=0,
                  stream_bytes=4):
    """Bound in ms of one chunk step at ThreePoint: its sweep's least work
    and, where the step reduces, K2 over the sweep's ``rows`` partial rows."""
    nbytes, flops = sweep_work(n, 1, n_store, streamed, reduce, pair, stream_bytes)
    if reduce:
        k2 = finish_work(rows, (1 + 2 * n_store) if pair else (1 + n_store))
        nbytes, flops = nbytes + k2[0], flops + k2[1]
    return bound((nbytes, flops))[0] * 1e3


# K1 and K3 kernels carry their stored-state count as the second template
# argument (``<EXT, NS, ...>``); the wide route reads it at run time, so a
# wide launch takes the count of the state it ran in.
_SWEEP = re.compile(r"(sweep_step\w*?_kernel)<\s*(\d+)\s*,\s*(\w+)")


def sweep_launch(name: str, state: int):
    """(kernel, ext, n_store, stream_bytes, pair) of a K1/K3 launch named
    ``name`` by the device trace, run while state ``state`` (its number of
    lower states) was solved; None for any other kernel."""
    m = _SWEEP.search(name)
    if m is None:
        return None
    kernel, ext = m.group(1), int(m.group(2))
    n_store = state if "_wide_" in kernel else int(m.group(3))
    stream_bytes = 2 if "_bf16" in kernel else 4
    return kernel, ext, n_store, stream_bytes, "_sc_" in kernel


def roofline_percent(record, pair: bool):
    """The least time of the traced stretch's K1 (``pair``: K3) launches
    over their device time, in %; None without a trace or a launch. Flops
    never bind at the cells' shapes (``bound`` picks bytes), so the
    reduction's flops, which a launch's name does not tell, are left out."""
    if record.trace is None:
        return None
    least = spent = 0.0
    for name, _start, dur, state in record.trace.device_ops:
        launch = sweep_launch(name, state)
        if launch is None or launch[4] != pair:
            continue
        _kernel, ext, n_store, stream_bytes, _pair = launch
        work = sweep_work(record.grid, ext, n_store, record.b_streams, False, pair, stream_bytes)
        least += bound(work)[0]
        spent += dur
    return 100.0 * least / spent if spent else None
