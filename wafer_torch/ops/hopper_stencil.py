"""The hand-written CUDA sweep (``csrc/stencil_sweep.cu``) bound to torch —
the Hopper counterpart of ``wafer_tpu/ops/pallas_stencil.py``.

Two kernels, each with a plain torch version of the same function in this
module and a launch counter (:data:`LAUNCHES`):

- :func:`sweep_step` (K1) replaces ``pallas_stencil._evolve_kernel`` (B2)
  and, looped with K2, ``_evolve_kernel_res`` (B1 ground/per-step-norm,
  B3 excited): one sweep ψ' = B·(2c + scale·L(c)) − c of the corrected
  input c = inv·ψ − Σₛ corrₛ·lₛ, with a zero Dirichlet shell, writing
  per-block partials of ‖ψ'‖² and ⟨lₛ|ψ'⟩.
- :func:`finish_coef` (K2) adds the partials in a fixed order in f64 and
  writes the reductions and the next step's coefficients
  ``[rsqrt(max(n², 1e-37)), ovₛ·inv]`` to device memory.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version. :func:`evolve_chunk` runs a whole
``screen_update`` chunk on the device with no host synchronisation.

Layout: the fully padded ``(N+2e)³`` arrays of the rest of the package
(the reference's x-padded layout exists only for TPU tiling). Stored-state
streams are f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from wafer_torch import geometry
from wafer_torch.errors import KernelLaunchError
from wafer_torch.ops import _build
from wafer_torch.ops.stencil import shifted

# analytic-B potential kinds; codes match csrc/stencil_sweep.cu ``Kind``
KINDS = {"NoPotential": 0, "Harmonic": 1, "Coulomb": 2, "SimpleCornell": 3, "Periodic": 4}
_STREAMED = -1

# launches of the kernel library's kernels (K1, K2 here, K3 in hopper_split)
# since the last reset_launches(); plain versions never count
LAUNCHES = {"sweep_step": 0, "finish_coef": 0, "sweep_step_sc": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------- #
# plain torch versions
# --------------------------------------------------------------------------- #


def analytic_v(analytic, shape, ext: int, device=None) -> torch.Tensor:
    """Interior raw V (no gauge shift) in f32 from padded-index coordinates —
    ``pallas_stencil._analytic_v`` and the kernels' ``analytic_v``.
    ``analytic`` = (kind, dn, dt, mass, ngx, ngy, ngz[, sig, …]); ``shape``
    is the padded ψ shape."""
    kind, dn, _dt, mass = analytic[:4]
    ng = analytic[4:7]
    sig = float(analytic[7]) if len(analytic) > 7 else 0.0
    f32 = torch.float32
    axes = [
        torch.arange(ext, n - ext, dtype=f32, device=device).reshape(
            [-1 if a == ax else 1 for a in range(3)]
        )
        for ax, n in enumerate(shape)
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


def analytic_b(analytic, shape, ext: int, device=None) -> torch.Tensor:
    """Interior B = 1/(1 + dt/2·(V − vshift)) in f32 from padded-index
    coordinates — the formula of ``pallas_stencil._analytic_b`` and of the
    kernel's ``analytic_b``. ``analytic`` = (kind, dn, dt, mass, ngx, ngy,
    ngz[, sig[, vshift]]); ``shape`` is the padded ψ shape."""
    dt = analytic[2]
    vshift = float(analytic[8]) if len(analytic) > 8 else 0.0
    return 1.0 / (1.0 + (0.5 * dt) * (analytic_v(analytic, shape, ext, device) - vshift))


def sweep_step_plain(
    psi, out, coef, partials, *, order, scale, analytic=None, b_int=None,
    store=None, apply_coef=False,
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
    b = b_int if analytic is None else analytic_b(analytic, psi.shape, ext, psi.device)
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
    nx, ny, nz = (d - 2 * ext for d in psi.shape)
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
) -> None:
    """K1: one sweep of padded ``psi`` into ``out`` (shell written zero).

    ``coef`` (1+S,) f32 holds [inv, corr_0..corr_{S-1}], read on the device
    and applied to the input when ``apply_coef``; ``store`` (S, *psi.shape)
    holds the lower states; ``partials`` (:func:`num_partials`, 1+S) f64
    receives the per-block sums of ‖ψ'‖² and ⟨lₛ|ψ'⟩, or is None for no
    reductions. B comes from ``analytic`` (the reference's tuple) or from
    the interior array ``b_int``."""
    if _device_kind(psi) == "cpu":
        sweep_step_plain(
            psi, out, coef, partials, order=order, scale=scale, analytic=analytic,
            b_int=b_int, store=store, apply_coef=apply_coef,
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
    if analytic is None:
        _require(b_int, "b_int", f32, (nx, ny, nz), dev)
        kind, dn, dt, mass, sig, vshift = _STREAMED, 0.0, 0.0, 0.0, 0.0, 0.0
    else:
        if analytic[0] not in KINDS:
            raise ValueError(f"unsupported analytic potential {analytic[0]}")
        if tuple(analytic[4:7]) != (nx, ny, nz):
            raise ValueError("analytic grid size does not match psi")
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
            kind, dn, dt, mass, sig, vshift,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_if_failed("sweep_step", code)
    LAUNCHES["sweep_step"] += 1


def finish_coef(partials: torch.Tensor, red: torch.Tensor, coef: torch.Tensor) -> None:
    """K2: ``red`` (1+S,) f64 ← the partials summed over blocks; ``coef``
    (1+S,) f32 ← [rsqrt(max(red₀, 1e-37)), redₛ·inv]."""
    if _device_kind(partials) == "cpu":
        finish_coef_plain(partials, red, coef)
        return
    dev = partials.device
    if partials.dim() != 2:
        raise ValueError("partials must be (n_blocks, 1+S)")
    n_blocks, n_red = partials.shape
    _require(partials, "partials", torch.float64, (n_blocks, n_red), dev)
    _require(red, "red", torch.float64, (n_red,), dev)
    _require(coef, "coef", torch.float32, (n_red,), dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.wafer_finish_coef(
            partials.data_ptr(), n_blocks, n_red, red.data_ptr(), coef.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_if_failed("finish_coef", code)
    LAUNCHES["finish_coef"] += 1


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
    ``pallas_stencil.evolve_chunk_resident`` (and of
    ``evolve_chunk_fused``, which computes the same chunk).

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
    partials = red = None
    if reduce:
        partials = torch.empty(
            num_partials(phi, order), 1 + n_store, dtype=torch.float64, device=phi.device
        )
        red = torch.empty(1 + n_store, dtype=torch.float64, device=phi.device)
    bufs = (torch.empty_like(phi), torch.empty_like(phi))
    src = phi
    for t in range(n_steps):
        dst = bufs[t % 2]
        sweep_step(
            src, dst, coef, partials, order=order, scale=scale, analytic=analytic,
            b_int=b_int, store=store, apply_coef=reduce,
        )
        if reduce:
            finish_coef(partials, red, coef)
        src = dst
    if n_store > 0:
        return src * coef[0] - torch.tensordot(coef[1:], store, dims=1)
    if per_step_norm:
        return src * coef[0]
    return src
