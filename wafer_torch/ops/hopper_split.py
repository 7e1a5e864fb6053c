"""The hand-written CUDA pair sweep (``csrc/split_sweep.cu``) bound to torch —
the Hopper counterpart of ``wafer_tpu/ops/pallas_split.py``.

:func:`sweep_step_sc` (K3) replaces ``pallas_split._evolve_kernel_sc``
(B8): one sweep ψ' = B·(2c + scale·L(c)) − c of the (re, im) pair, with
complex B and the corrected input c = inv·ψ − Σₛ(crₛ + i·ciₛ)·lₛ, a zero
Dirichlet shell, and per-block partials of ‖ψ'‖², Re⟨lₛ|ψ'⟩ and Im⟨lₛ|ψ'⟩.
Looped with K2 (``hopper_stencil.finish_coef``, unchanged, with
``n_red = 1 + 2S``) by :func:`evolve_chunk_sc`, it also replaces the four
chunk kernels B7, B9, B10 and B11, which on one device compute the same
chunk.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version beside it. Launches are counted in
``hopper_stencil.LAUNCHES["sweep_step_sc"]``.

Layout: ψ pair ``(2, N+2e, N+2e, N+2e)`` re then im, streamed B
``(2, N, N, N)`` as (Br, Bi), stored pairs ``(S, 2, N+2e, N+2e, N+2e)``,
coef ``(1+2S,)`` = [inv, cr₀, ci₀, …]. The reference's x-stacked layout
(``pallas_split.to_xpad_sc``) exists for TPU tiling and is not used.
"""

from __future__ import annotations

from typing import Optional

import torch

from wafer_torch import geometry
from wafer_torch.ops import _build, hopper_stencil as hs
from wafer_torch.ops.stencil import stencil_taps

# complex analytic-B kinds (the real counterpart's V); codes of hopper_stencil.KINDS
KINDS = ("Harmonic", "Coulomb")


def num_partials(pair: torch.Tensor, order: str) -> int:
    """Rows of the partials scratch a sweep of ``pair`` writes."""
    return hs.num_partials(pair[0], order)


# --------------------------------------------------------------------------- #
# plain torch versions
# --------------------------------------------------------------------------- #


def analytic_b_sc(analytic, shape, ext: int, device=None):
    """Interior complex B = 1/(1 + dt/2·(V − vshift + i·absorb·V)) in f32
    from padded-index coordinates, as (Br, Bi) — the formula of
    ``pallas_split._analytic_b_sc`` and of the kernel. ``analytic`` is the
    reference's tuple (kind, dn, dt, mass, nx, ny, nz, sig, vshift,
    absorb); ``shape`` is one padded component's shape."""
    dt = analytic[2]
    vshift = float(analytic[8]) if len(analytic) > 8 else 0.0
    absorb = float(analytic[9]) if len(analytic) > 9 else 0.0
    v = hs.analytic_v(analytic, shape, ext, device)
    dr = 1.0 + (0.5 * dt) * (v - vshift)
    di = (0.5 * dt) * (absorb * v)
    mag = dr * dr + di * di
    return dr / mag, -di / mag


def sweep_step_sc_plain(
    psi, out, coef, partials, *, order, scale, analytic=None, b2=None,
    store=None, apply_coef=False,
) -> None:
    """Plain torch version of :func:`sweep_step_sc` (same arguments)."""
    ext = geometry.EXT[order]
    n_store = 0 if store is None else store.shape[0]
    cr, ci = psi[0], psi[1]
    if apply_coef:
        cr, ci = psi[0] * coef[0], psi[1] * coef[0]
        for s in range(n_store):
            ar, ai = coef[1 + 2 * s], coef[2 + 2 * s]
            lr, li = store[s, 0], store[s, 1]
            cr, ci = cr - (ar * lr - ai * li), ci - (ar * li + ai * lr)
    c0r, c0i = geometry.work_area(cr, ext), geometry.work_area(ci, ext)
    if analytic is None:
        br, bi = b2[0], b2[1]
    else:
        br, bi = analytic_b_sc(analytic, psi.shape[1:], ext, psi.device)
    ur = 2.0 * c0r + scale * stencil_taps(cr, order)
    ui = 2.0 * c0i + scale * stencil_taps(ci, order)
    new_r = br * ur - bi * ui - c0r
    new_i = br * ui + bi * ur - c0i
    out.zero_()
    geometry.work_area(out, ext).copy_(torch.stack([new_r, new_i]))
    if partials is not None:
        sums = [torch.sum((new_r * new_r + new_i * new_i).double())]
        for s in range(n_store):
            lr, li = geometry.work_area(store[s], ext)
            sums += [torch.sum((lr * new_r + li * new_i).double()),
                     torch.sum((lr * new_i - li * new_r).double())]
        partials.zero_()
        partials[0].copy_(torch.stack(sums))


# --------------------------------------------------------------------------- #
# the kernel wrapper
# --------------------------------------------------------------------------- #


def sweep_step_sc(
    psi: torch.Tensor,
    out: torch.Tensor,
    coef: torch.Tensor,
    partials: Optional[torch.Tensor],
    *,
    order: str,
    scale: float,
    analytic=None,
    b2: Optional[torch.Tensor] = None,
    store: Optional[torch.Tensor] = None,
    apply_coef: bool = False,
) -> None:
    """K3: one sweep of the padded pair ``psi`` into ``out`` (shell written
    zero).

    ``coef`` (1+2S,) f32 holds [inv, cr₀, ci₀, …], read on the device and
    applied to the input when ``apply_coef``; ``store`` (S, 2, …) holds the
    lower pairs; ``partials`` (:func:`num_partials`, 1+2S) f64 receives the
    per-block sums of ‖ψ'‖², Re⟨lₛ|ψ'⟩ and Im⟨lₛ|ψ'⟩, or is None for no
    reductions. B comes from ``analytic`` (the reference's tuple, kind
    Harmonic or Coulomb) or from the interior pair ``b2``."""
    if hs._device_kind(psi) == "cpu":
        sweep_step_sc_plain(
            psi, out, coef, partials, order=order, scale=scale, analytic=analytic,
            b2=b2, store=store, apply_coef=apply_coef,
        )
        return
    ext = geometry.EXT[order]
    dev = psi.device
    f32 = torch.float32
    if psi.dim() != 4 or psi.shape[0] != 2:
        raise ValueError("psi must be a padded (2, ...) (re, im) pair")
    nx, ny, nz = (d - 2 * ext for d in psi.shape[1:])
    hs._require(psi, "psi", f32, psi.shape, dev)
    hs._require(out, "out", f32, psi.shape, dev)
    if out.data_ptr() == psi.data_ptr():
        raise ValueError("sweep_step_sc cannot run in place")
    n_store = 0 if store is None else store.shape[0]
    if store is not None:
        hs._require(store, "store", f32, (n_store, *psi.shape), dev)
    hs._require(coef, "coef", f32, (1 + 2 * n_store,), dev)
    if partials is not None:
        hs._require(partials, "partials", torch.float64,
                    (num_partials(psi, order), 1 + 2 * n_store), dev)
    if analytic is None:
        hs._require(b2, "b2", f32, (2, nx, ny, nz), dev)
        kind, dn, dt, vshift, absorb = hs._STREAMED, 0.0, 0.0, 0.0, 0.0
    else:
        if analytic[0] not in KINDS:
            raise ValueError(f"unsupported complex analytic potential {analytic[0]}")
        if tuple(analytic[4:7]) != (nx, ny, nz):
            raise ValueError("analytic grid size does not match psi")
        kind = hs.KINDS[analytic[0]]
        dn, dt = float(analytic[1]), float(analytic[2])
        vshift = float(analytic[8]) if len(analytic) > 8 else 0.0
        absorb = float(analytic[9]) if len(analytic) > 9 else 0.0
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.wafer_sweep_step_sc(
            psi.data_ptr(), out.data_ptr(),
            None if analytic is not None else b2.data_ptr(),
            None if store is None else store.data_ptr(),
            coef.data_ptr(),
            None if partials is None else partials.data_ptr(),
            nx, ny, nz, ext, n_store, int(apply_coef), float(scale),
            kind, dn, dt, vshift, absorb,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    hs._raise_if_failed("sweep_step_sc", code)
    hs.LAUNCHES["sweep_step_sc"] += 1


# --------------------------------------------------------------------------- #
# the chunk loop
# --------------------------------------------------------------------------- #


def evolve_chunk_sc(
    pair: torch.Tensor,
    order: str,
    dt: float,
    dn: float,
    mass: float,
    n_steps: int,
    analytic=None,
    per_step_norm: bool = False,
    store: Optional[torch.Tensor] = None,
    b2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``n_steps`` pair sweeps entirely on the device: the counterpart of
    ``pallas_split.evolve_chunk_fused_sc`` and of every resident variant
    (``evolve_chunk_resident_sc``, ``_resident_mixed_sc``,
    ``_resident_blocked_sc``, ``evolve_chunk_fused_k_sc``).

    Ground state: K3 per step, no reductions. ``per_step_norm`` and stored
    pairs ``store`` (S, *pair.shape) run K2 after every K3, which carries
    the split recursion coef = [inv, Re ovₛ·inv, Im ovₛ·inv] on the device;
    the last step's pending correction ψ·inv − Σ(cr + i·ci)·lₛ is applied
    here as plain tensor ops (pallas_split.py:602-613). ``pair`` is not
    modified."""
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    scale = dt / (k * dn * dn * mass)
    n_store = 0 if store is None else store.shape[0]
    reduce = per_step_norm or n_store > 0
    if analytic is None and b2 is None:
        raise ValueError("evolve_chunk_sc needs either analytic or b2")
    coef = torch.zeros(1 + 2 * n_store, dtype=torch.float32, device=pair.device)
    coef[0] = 1.0  # the identity: the first step sweeps ψ as it is
    partials = red = None
    if reduce:
        partials = torch.empty(
            num_partials(pair, order), 1 + 2 * n_store, dtype=torch.float64,
            device=pair.device,
        )
        red = torch.empty(1 + 2 * n_store, dtype=torch.float64, device=pair.device)
    bufs = (torch.empty_like(pair), torch.empty_like(pair))
    src = pair
    for t in range(n_steps):
        dst = bufs[t % 2]
        sweep_step_sc(
            src, dst, coef, partials, order=order, scale=scale, analytic=analytic,
            b2=b2, store=store, apply_coef=reduce,
        )
        if reduce:
            hs.finish_coef(partials, red, coef)
        src = dst
    if n_store > 0:
        cr, ci = coef[1::2], coef[2::2]
        lr, li = store[:, 0], store[:, 1]
        re = src[0] * coef[0] - (torch.tensordot(cr, lr, dims=1) - torch.tensordot(ci, li, dims=1))
        im = src[1] * coef[0] - (torch.tensordot(cr, li, dims=1) + torch.tensordot(ci, lr, dims=1))
        return torch.stack([re, im])
    if per_step_norm:
        return src * coef[0]
    return src
