"""The hand-written CUDA sweep (``csrc/stencil_sweep.cu``) bound to torch —
the Hopper counterpart of ``wafer_tpu/ops/pallas_stencil.py``.

Two kernels, each with a plain torch version of the same function in this
module and a launch counter (:data:`LAUNCHES`):

- :func:`sweep_step` (K1) replaces ``pallas_stencil._evolve_kernel`` (B2)
  and, looped with K2, ``_evolve_kernel_res`` (B1 ground/per-step-norm,
  B3 excited) and the large-grid kernels ``_evolve_kernel_k`` (B5),
  ``_evolve_kernel_resb`` (B6) and ``_evolve_kernel_kgs`` (B4): one sweep
  ψ' = B·(2c + scale·L(c)) − c of the corrected input
  c = inv·ψ − Σₛ corrₛ·lₛ, with a zero Dirichlet shell, writing per-block
  partials of ‖ψ'‖² and ⟨lₛ|ψ'⟩.
- :func:`finish_coef` (K2, ``csrc/finish_coef.cu``) adds the partials in a
  fixed order in f64 and writes the reductions and the next step's
  coefficients ``[rsqrt(max(n², 1e-37)), ovₛ·inv]`` to device memory.
  A chunk binds it once with :func:`finish_launcher`, which owns K2's
  scratch, so a step pays the launch and not the checks.

Given a shard block of a device mesh and its ``origin`` in the global grid
(``parallel/sharded.py``), K1 reads the analytic B at global coordinates, so
a block computes each point exactly as the whole grid does: the sharded
modes of B1–B6 and the mesh-only kernels B12–B14. Its ``partials`` may be a
row range of one buffer that K2 then adds over every shard.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version. :func:`evolve_chunk` runs a whole
``screen_update`` chunk on the device with no host synchronisation.

Layout: the fully padded ``(N+2e)³`` arrays of the rest of the package
(the reference's x-padded layout exists only for TPU tiling). Stored-state
streams are f32.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from wafer_torch import geometry
from wafer_torch.config import Config, PotentialType
from wafer_torch.errors import KernelLaunchError
from wafer_torch.ops import _build
from wafer_torch.ops.stencil import shifted

# analytic-B potential kinds; codes match csrc/stencil_sweep.cu ``Kind``
KINDS = {"NoPotential": 0, "Harmonic": 1, "Coulomb": 2, "SimpleCornell": 3, "Periodic": 4}
_STREAMED = -1
# the potentials whose B the sweeps compute from coordinates; a complex
# potential looks up its real counterpart (Harmonic and Coulomb, the kinds
# of hopper_split.KINDS; FullCornell streams its B)
_FORMULA = {
    PotentialType.NO_POTENTIAL: "NoPotential",
    PotentialType.HARMONIC: "Harmonic",
    PotentialType.COULOMB: "Coulomb",
    PotentialType.SIMPLE_CORNELL: "SimpleCornell",
    PotentialType.PERIODIC: "Periodic",
}

# launches of the kernel library's kernels (K1, K2 here, K3 in hopper_split)
# since the last reset_launches(); plain versions never count
LAUNCHES = {"sweep_step": 0, "finish_coef": 0, "sweep_step_sc": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def analytic_params(config: Config, v_shift: float):
    """The reference's analytic tuple (kind, dn, dt, mass, nx, ny, nz, sig,
    v_shift[, absorb]) for a potential whose B the sweeps compute from
    coordinates (absorb for a complex one), or None when B is streamed.
    ``v_shift`` is the gauge shift baked into the arrays A and B."""
    split = config.potential.is_complex
    kind = _FORMULA.get(config.potential.real_counterpart if split else config.potential)
    if kind is None:
        return None
    g = config.grid
    return (
        kind, g.dn, g.dt, config.mass, g.size.x, g.size.y, g.size.z, config.sig, v_shift,
    ) + ((config.absorb,) if split else ())


# --------------------------------------------------------------------------- #
# plain torch versions
# --------------------------------------------------------------------------- #


def analytic_v(analytic, shape, ext: int, device=None, origin=(0, 0, 0)) -> torch.Tensor:
    """Interior raw V (no gauge shift) in f32 from padded-index coordinates —
    ``pallas_stencil._analytic_v`` and the kernels' ``analytic_v``.
    ``analytic`` = (kind, dn, dt, mass, ngx, ngy, ngz[, sig, …]) with the
    global extents ng; ``shape`` is the padded shape of the block whose
    interior starts at ``origin`` in the global interior (the whole grid at
    the zero origin)."""
    kind, dn, _dt, mass = analytic[:4]
    ng = analytic[4:7]
    sig = float(analytic[7]) if len(analytic) > 7 else 0.0
    f32 = torch.float32
    axes = [
        torch.arange(ext + o, n - ext + o, dtype=f32, device=device).reshape(
            [-1 if a == ax else 1 for a in range(3)]
        )
        for ax, (n, o) in enumerate(zip(shape, origin))
    ]
    if kind == "Periodic":
        two_pi = 2.0 * 3.14159265358979323846
        s = [torch.sin(two_pi * (x - 1.0) / (g - 1.0)) ** 2 for x, g in zip(axes, ng)]
        return 1.0 - s[0] * (s[1] * s[2])
    d = [x - (g + 1.0) / 2.0 for x, g in zip(axes, ng)]
    r2 = d[0] * d[0] + (d[1] * d[1] + d[2] * d[2])
    if kind == "Harmonic":
        return (0.5 * dn * dn) * r2
    if kind in ("Coulomb", "SimpleCornell"):
        r = dn * torch.sqrt(r2)
        rs = torch.clamp(r, min=dn)
        if kind == "Coulomb":
            return torch.where(r < dn, -1.0 / dn, -1.0 / rs)
        far = (-0.5 * (4.0 / 3.0) / rs + sig * rs) + 4.0 * mass
        return torch.where(r < dn, 4.0 * mass, far)
    if kind == "NoPotential":
        return torch.zeros_like(r2)
    raise ValueError(f"unsupported analytic potential {kind}")


def analytic_b(analytic, shape, ext: int, device=None, origin=(0, 0, 0)) -> torch.Tensor:
    """Interior B = 1/(1 + dt/2·(V − vshift)) in f32 from padded-index
    coordinates — the formula of ``pallas_stencil._analytic_b`` and of the
    kernel's ``analytic_b``. ``analytic`` = (kind, dn, dt, mass, ngx, ngy,
    ngz[, sig[, vshift]]); ``shape`` and ``origin`` as :func:`analytic_v`."""
    dt = analytic[2]
    vshift = float(analytic[8]) if len(analytic) > 8 else 0.0
    v = analytic_v(analytic, shape, ext, device, origin)
    return 1.0 / (1.0 + (0.5 * dt) * (v - vshift))


def sweep_step_plain(
    psi, out, coef, partials, *, order, scale, analytic=None, b_int=None,
    store=None, apply_coef=False, origin=(0, 0, 0),
) -> None:
    """Plain torch version of :func:`sweep_step` (same arguments)."""
    ext = geometry.EXT[order]
    offsets, coeffs, center, _k = geometry.stencil_coefficients(order)
    n_store = 0 if store is None else store.shape[0]
    c = psi
    if apply_coef:
        c = psi * coef[0]
        for s in range(n_store):
            c = c - coef[1 + s] * store[s]
    c0 = geometry.work_area(c, ext)
    acc = -center * c0
    for off, cf in zip(offsets, coeffs):
        for axis in range(3):
            acc = acc + cf * (shifted(c, ext, axis, off) + shifted(c, ext, axis, -off))
    b = b_int if analytic is None else analytic_b(analytic, psi.shape, ext, psi.device, origin)
    new = b * (2.0 * c0 + scale * acc) - c0
    out.zero_()
    geometry.work_area(out, ext).copy_(new)
    if partials is not None:
        sums = [torch.sum((new * new).double())]
        sums += [
            torch.sum((geometry.work_area(store[s], ext) * new).double())
            for s in range(n_store)
        ]
        partials.zero_()
        partials[0].copy_(torch.stack(sums))


def finish_coef_plain(partials, red, coef) -> None:
    """Plain torch version of :func:`finish_coef`."""
    red.copy_(partials.sum(dim=0))
    inv = torch.rsqrt(torch.clamp(red[0], min=1e-37))
    coef.copy_(torch.cat([inv[None], red[1:] * inv]))


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _require(t, name, dtype, shape, device):
    if t is None:
        raise ValueError(f"{name} is required")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous tensor on {device}")


def check_origin(analytic, block, origin) -> None:
    """The block of extents ``block`` at ``origin`` lies inside the global
    extents of ``analytic``."""
    if any(o < 0 or o + n > g for o, n, g in zip(origin, block, analytic[4:7])):
        raise ValueError(
            f"analytic grid size {tuple(analytic[4:7])} does not hold the "
            f"block {tuple(block)} at origin {tuple(origin)}"
        )


def _raise_if_failed(kernel: str, code: int) -> None:
    if code != 0:
        text = _build.library().wafer_error_string(code).decode()
        raise KernelLaunchError(kernel, code, text)


def num_partials(psi: torch.Tensor, order: str) -> int:
    """Rows of the partials scratch a sweep of ``psi`` writes: one per
    CUDA block, one for the plain version."""
    if _device_kind(psi) == "cpu":
        return 1
    ext = geometry.EXT[order]
    return _num_blocks(*(d - 2 * ext for d in psi.shape), ext)


@functools.lru_cache(maxsize=None)
def _num_blocks(nx: int, ny: int, nz: int, ext: int) -> int:
    return _build.library().wafer_sweep_num_blocks(nx, ny, nz, ext)


def sweep_step(
    psi: torch.Tensor,
    out: torch.Tensor,
    coef: torch.Tensor,
    partials: Optional[torch.Tensor],
    *,
    order: str,
    scale: float,
    analytic=None,
    b_int: Optional[torch.Tensor] = None,
    store: Optional[torch.Tensor] = None,
    apply_coef: bool = False,
    origin=(0, 0, 0),
) -> None:
    """K1: one sweep of padded ``psi`` into ``out`` (shell written zero).

    ``coef`` (1+S,) f32 holds [inv, corr_0..corr_{S-1}], read on the device
    and applied to the input when ``apply_coef``; ``store`` (S, *psi.shape)
    holds the lower states; ``partials`` (:func:`num_partials`, 1+S) f64
    receives the per-block sums of ‖ψ'‖² and ⟨lₛ|ψ'⟩, or is None for no
    reductions. B comes from ``analytic`` (the reference's tuple, with the
    global extents) at the block's ``origin`` in the global interior, or
    from the interior array ``b_int``. ``partials`` may be a row range of a
    larger buffer (a view with its own data pointer)."""
    if _device_kind(psi) == "cpu":
        sweep_step_plain(
            psi, out, coef, partials, order=order, scale=scale, analytic=analytic,
            b_int=b_int, store=store, apply_coef=apply_coef, origin=origin,
        )
        return
    ext = geometry.EXT[order]
    dev = psi.device
    f32 = torch.float32
    if psi.dim() != 3:
        raise ValueError("psi must be a padded 3-D array")
    nx, ny, nz = (d - 2 * ext for d in psi.shape)
    _require(psi, "psi", f32, psi.shape, dev)
    _require(out, "out", f32, psi.shape, dev)
    if out.data_ptr() == psi.data_ptr():
        raise ValueError("sweep_step cannot run in place")
    n_store = 0 if store is None else store.shape[0]
    if store is not None:
        _require(store, "store", f32, (n_store, *psi.shape), dev)
    _require(coef, "coef", f32, (1 + n_store,), dev)
    if partials is not None:
        _require(partials, "partials", torch.float64,
                 (num_partials(psi, order), 1 + n_store), dev)
    gnx, gny, gnz = nx, ny, nz
    if analytic is None:
        _require(b_int, "b_int", f32, (nx, ny, nz), dev)
        kind, dn, dt, mass, sig, vshift = _STREAMED, 0.0, 0.0, 0.0, 0.0, 0.0
    else:
        if analytic[0] not in KINDS:
            raise ValueError(f"unsupported analytic potential {analytic[0]}")
        check_origin(analytic, (nx, ny, nz), origin)
        gnx, gny, gnz = (int(g) for g in analytic[4:7])
        kind = KINDS[analytic[0]]
        dn, dt, mass = (float(x) for x in analytic[1:4])
        sig = float(analytic[7]) if len(analytic) > 7 else 0.0
        vshift = float(analytic[8]) if len(analytic) > 8 else 0.0
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.wafer_sweep_step(
            psi.data_ptr(), out.data_ptr(),
            None if b_int is None or analytic is not None else b_int.data_ptr(),
            None if store is None else store.data_ptr(),
            coef.data_ptr(),
            None if partials is None else partials.data_ptr(),
            nx, ny, nz, ext, n_store, int(apply_coef), float(scale),
            kind, gnx, gny, gnz, *(int(o) for o in origin), dn, dt, mass, sig, vshift,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_if_failed("sweep_step", code)
    LAUNCHES["sweep_step"] += 1


# K2's launch shape (csrc/finish_coef.cu): a thread loads 4 rows before
# adding them. One block of 512 threads adds up to FINISH_ONE_BLOCK doubles
# (rows × n_red), since its time grows with the bytes it reads; above that,
# groups of 256 threads take about FINISH_GROUP rows each (one round of
# loads), at most FINISH_MAX_GROUPS of them, and the hand-over to the last
# group costs about as much as one block reading 16,384 doubles. Chosen from
# times on an H100 (tools/tune_finish.py, chip_smoke.py phase 2e).
FINISH_ONE_BLOCK = 16384
FINISH_GROUP = 1024
FINISH_MAX_GROUPS = 256


def finish_groups(n_blocks: int, n_red: int) -> int:
    """Blocks of K2 that share ``n_blocks`` partial rows of ``n_red`` columns."""
    if n_blocks * n_red <= FINISH_ONE_BLOCK:
        return 1
    return min(FINISH_MAX_GROUPS, -(-n_blocks // FINISH_GROUP))


def finish_launcher(partials: torch.Tensor, red: torch.Tensor,
                    coef: torch.Tensor) -> Callable[[], None]:
    """K2 bound to these tensors: the checks of :func:`finish_coef` run
    once, and each call of the returned function launches the kernel on
    the stream current now, or raises. A chunk makes it once and calls it
    every step. The launcher owns K2's scratch (``launch.scratch``), made
    zeroed here: the ticket of the last block, which each launch leaves
    zero for the next, and one row of sums a group, f64 ``(1 + G·n_red,)``;
    it holds ``launch.tensors``, so every pointer it launches with stays
    valid while it lives. On CPU tensors the call runs the plain version."""
    kind = _device_kind(partials)
    dev = partials.device
    if partials.dim() != 2:
        raise ValueError("partials must be (n_blocks, 1+S)")
    n_blocks, n_red = partials.shape
    _require(partials, "partials", torch.float64, (n_blocks, n_red), dev)
    _require(red, "red", torch.float64, (n_red,), dev)
    _require(coef, "coef", torch.float32, (n_red,), dev)
    if kind == "cpu":
        return functools.partial(finish_coef_plain, partials, red, coef)
    groups = finish_groups(n_blocks, n_red)
    scratch = torch.zeros(1 + groups * n_red, dtype=torch.float64, device=dev)
    fn = _build.library().wafer_finish_coef
    args = (partials.data_ptr(), n_blocks, n_red, red.data_ptr(), coef.data_ptr(),
            scratch.data_ptr(), groups, dev.index, torch.cuda.current_stream(dev).cuda_stream)

    def launch() -> None:
        _raise_if_failed("finish_coef", fn(*args))
        LAUNCHES["finish_coef"] += 1

    launch.scratch = scratch
    launch.tensors = (partials, red, coef, scratch)
    return launch


def finish_coef(partials: torch.Tensor, red: torch.Tensor, coef: torch.Tensor) -> None:
    """K2: ``red`` (1+S,) f64 ← the partials summed over blocks in a fixed
    order; ``coef`` (1+S,) f32 ← [rsqrt(max(red₀, 1e-37)), redₛ·inv]."""
    finish_launcher(partials, red, coef)()


# --------------------------------------------------------------------------- #
# the chunk loop
# --------------------------------------------------------------------------- #


def evolve_chunk(
    phi: torch.Tensor,
    order: str,
    dt: float,
    dn: float,
    mass: float,
    n_steps: int,
    analytic=None,
    per_step_norm: bool = False,
    store: Optional[torch.Tensor] = None,
    b_int: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``n_steps`` sweeps entirely on the device: the counterpart of
    ``pallas_stencil.evolve_chunk_resident`` and of the functions that
    compute the same chunk with another TPU residency scheme:
    ``evolve_chunk_fused`` (1-step sweeps), ``evolve_chunk_fused_k`` (K
    ground steps per HBM pass, B5), ``evolve_chunk_resident_blocked`` (R
    deep-halo ground steps per x-block, B6) and ``evolve_chunk_fused_kgs``
    (two per-step normalise-and-project steps per pass with the correction
    deferred through Gram matrices, B4; exact in exact arithmetic). On the
    card one K1 (+ K2) launch per step, at every grid size, computes each
    of them: there is no VMEM to stay inside, so the chunk needs no
    picker.

    Ground state: K1 per step, no reductions. ``per_step_norm`` (the f32
    drift guard) and stored states ``store`` (S, *phi.shape) run K2 after
    every K1, which carries the reference's exact per-step
    normalise-then-project recursion (src/grid.rs:674-681) in ``coef``;
    the last step's pending correction is applied here as plain tensor
    ops, as pallas_stencil.py:2962-2970 does. ``phi`` is not modified."""
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    scale = dt / (k * dn * dn * mass)
    n_store = 0 if store is None else store.shape[0]
    reduce = per_step_norm or n_store > 0
    if analytic is None and b_int is None:
        raise ValueError("evolve_chunk needs either analytic or b_int")
    coef = torch.zeros(1 + n_store, dtype=torch.float32, device=phi.device)
    coef[0] = 1.0  # the identity: the first step sweeps ψ as it is
    partials = finish = None
    if reduce:
        partials = torch.empty(
            num_partials(phi, order), 1 + n_store, dtype=torch.float64, device=phi.device
        )
        red = torch.empty(1 + n_store, dtype=torch.float64, device=phi.device)
        finish = finish_launcher(partials, red, coef)
    bufs = (torch.empty_like(phi), torch.empty_like(phi))
    src = phi
    for t in range(n_steps):
        dst = bufs[t % 2]
        sweep_step(
            src, dst, coef, partials, order=order, scale=scale, analytic=analytic,
            b_int=b_int, store=store, apply_coef=reduce,
        )
        if reduce:
            finish()
        src = dst
    return finish_chunk(src, coef, store, per_step_norm)


def finish_chunk(src, coef, store, per_step_norm: bool) -> torch.Tensor:
    """The last step's pending coefficients applied to the sweep's output:
    ψ·inv − Σₛ corrₛ·lₛ with stored states, ψ·inv for a per-step-norm
    chunk, ψ as it is for a ground chunk."""
    if store is not None and store.shape[0] > 0:
        return src * coef[0] - torch.tensordot(coef[1:], store, dims=1)
    if per_step_norm:
        return src * coef[0]
    return src
