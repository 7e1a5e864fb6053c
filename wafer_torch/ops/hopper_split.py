"""The hand-written CUDA pair sweep (``csrc/split_sweep.cu``; with three or
more stored pairs ``csrc/stencil_sweep_wide.cu``) bound to torch —
the Hopper counterpart of ``wafer_tpu/ops/pallas_split.py``.

:func:`sweep_step_sc` (K3) replaces ``pallas_split._evolve_kernel_sc``
(B8): one sweep ψ' = B·(2c + scale·L(c)) − c of the (re, im) pair, with
complex B and the corrected input c = inv·ψ − Σₛ(crₛ + i·ciₛ)·lₛ, a zero
Dirichlet shell, and per-block partials of ‖ψ'‖², Re⟨lₛ|ψ'⟩ and Im⟨lₛ|ψ'⟩.
Looped with K2 (``hopper_stencil.finish_coef``, ``csrc/finish_coef.cu``,
with ``n_red = 1 + 2S``) by :func:`evolve_chunk_sc`, it also replaces the four
chunk kernels B7, B9, B10 and B11, which on one device compute the same
chunk.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version beside it. Launches are counted in
``hopper_stencil.LAUNCHES`` under their route (``hopper_stencil.route``):
``"sweep_step_sc"``, or ``"sweep_step_sc_wide"`` with three or more stored pairs.

Layout: ψ pair ``(2, N+2e, N+2e, N+2e)`` re then im, streamed B
``(2, N, N, N)`` as (Br, Bi), stored pairs ``(S, 2, N+2e, N+2e, N+2e)``,
coef ``(1+2S,)`` = [inv, cr₀, ci₀, …]. The reference's x-stacked layout
(``pallas_split.to_xpad_sc``) exists for TPU tiling and is not used.
"""

from __future__ import annotations

from typing import Optional

import torch

from wafer_torch import chunk_graph, geometry
from wafer_torch.ops import _build, hopper_stencil as hs
from wafer_torch.ops.stencil import stencil_taps

# complex analytic-B kinds (the real counterpart's V); codes of hopper_stencil.KINDS
KINDS = ("Harmonic", "Coulomb")


def num_partials(pair: torch.Tensor, order: str) -> int:
    """Rows of the partials scratch a sweep of ``pair`` writes: one per
    CUDA block of K3, one for the plain version."""
    if hs._device_kind(pair) == "cpu":
        return 1
    ext = geometry.EXT[order]
    return hs._num_blocks(*(d - 2 * ext for d in pair.shape[1:]), ext)


# --------------------------------------------------------------------------- #
# plain torch versions
# --------------------------------------------------------------------------- #


def analytic_b_sc(analytic, shape, ext: int, device=None, origin=(0, 0, 0)):
    """Interior complex B = 1/(1 + dt/2·(V − vshift + i·absorb·V)) in f32
    from padded-index coordinates, as (Br, Bi) — the formula of
    ``pallas_split._analytic_b_sc`` and of the kernel. ``analytic`` is the
    reference's tuple (kind, dn, dt, mass, nx, ny, nz, sig, vshift,
    absorb) with the global extents; ``shape`` is one padded component's
    shape, of the block whose interior starts at ``origin``."""
    dt = analytic[2]
    vshift = float(analytic[8]) if len(analytic) > 8 else 0.0
    absorb = float(analytic[9]) if len(analytic) > 9 else 0.0
    v = hs.analytic_v(analytic, shape, ext, device, origin)
    dr = 1.0 + (0.5 * dt) * (v - vshift)
    di = (0.5 * dt) * (absorb * v)
    mag = dr * dr + di * di
    return dr / mag, -di / mag


def sweep_step_sc_plain(
    psi, out, coef, partials, *, order, scale, analytic=None, b2=None,
    store=None, apply_coef=False, origin=(0, 0, 0), grid=None, red=None, done=None,
) -> None:
    """Plain torch version of :func:`sweep_step_sc` (same arguments); it
    ignores ``done``, as :func:`hopper_stencil.sweep_step_plain` does."""
    ext = geometry.EXT[order]
    n_store = 0 if store is None else store.shape[0]
    block = tuple(d - 2 * ext for d in psi.shape[1:])
    (g0, g1), (r0, r1) = hs.x_windows(block[0], origin, hs._grid(analytic, grid, block, origin),
                                      red)
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
        br, bi = analytic_b_sc(analytic, psi.shape[1:], ext, psi.device, origin)
    ur = 2.0 * c0r + scale * stencil_taps(cr, order)
    ui = 2.0 * c0i + scale * stencil_taps(ci, order)
    new = torch.stack([br * ur - bi * ui - c0r, br * ui + bi * ur - c0i])
    new[:, :g0].zero_()  # planes outside the grid
    new[:, g1:].zero_()
    out.zero_()
    geometry.work_area(out, ext).copy_(new)
    if partials is not None:
        new_r, new_i = new[:, r0:r1]
        sums = [torch.sum((new_r * new_r + new_i * new_i).double())]
        for s in range(n_store):
            lr, li = geometry.work_area(store[s], ext)[:, r0:r1]
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
    origin=(0, 0, 0),
    grid=None,
    red=None,
    done: Optional[torch.Tensor] = None,
) -> None:
    """K3: one sweep of the padded pair ``psi`` into ``out`` (shell written
    zero).

    ``coef`` (1+2S,) f32 holds [inv, cr₀, ci₀, …], read on the device and
    applied to the input when ``apply_coef``; ``store`` (S, 2, …) holds the
    lower pairs; ``partials`` (:func:`num_partials`, 1+2S) f64 receives the
    per-block sums of ‖ψ'‖², Re⟨lₛ|ψ'⟩ and Im⟨lₛ|ψ'⟩, or is None for no
    reductions. B comes from ``analytic`` (the reference's tuple, kind
    Harmonic or Coulomb, global extents) at the block's ``origin``, or from
    the interior pair ``b2``; ``partials``, a deep block's ``grid``, the
    reduction window ``red`` and a batch's flag ``done`` as
    :func:`hopper_stencil.sweep_step`."""
    if hs._device_kind(psi) == "cpu":
        sweep_step_sc_plain(
            psi, out, coef, partials, order=order, scale=scale, analytic=analytic,
            b2=b2, store=store, apply_coef=apply_coef, origin=origin, grid=grid, red=red,
        )
        return
    hs.require_apart(psi, out, "sweep_step_sc")
    bind_sweep_sc(
        psi, coef, partials, order=order, scale=scale, analytic=analytic, b2=b2, store=store,
        apply_coef=apply_coef, origin=origin, grid=grid, red=red, done=done,
    )(psi, out)


def bind_sweep_sc(
    like: torch.Tensor,
    coef: torch.Tensor,
    partials: Optional[torch.Tensor],
    *,
    order: str,
    scale: float,
    analytic=None,
    b2: Optional[torch.Tensor] = None,
    store: Optional[torch.Tensor] = None,
    apply_coef: bool = False,
    origin=(0, 0, 0),
    grid=None,
    red=None,
    done: Optional[torch.Tensor] = None,
    stream: Optional[torch.cuda.Stream] = None,
):
    """K3 bound to everything but its pair and output, checked once against
    ``like``: ``launch(src, dst)``, as :func:`hopper_stencil.bind_sweep`
    binds K1. Arguments as :func:`sweep_step_sc`."""
    if hs._device_kind(like) == "cpu":
        def plain(src, dst):
            sweep_step_sc_plain(
                src, dst, coef, partials, order=order, scale=scale, analytic=analytic,
                b2=b2, store=store, apply_coef=apply_coef, origin=origin, grid=grid, red=red,
            )
        return plain
    ext = geometry.EXT[order]
    dev = like.device
    f32 = torch.float32
    if like.dim() != 4 or like.shape[0] != 2:
        raise ValueError("psi must be a padded (2, ...) (re, im) pair")
    nx, ny, nz = (d - 2 * ext for d in like.shape[1:])
    hs._require(like, "psi", f32, like.shape, dev)
    n_store = 0 if store is None else store.shape[0]
    if store is not None:
        hs._require(store, "store", f32, (n_store, *like.shape), dev)
    hs._require(coef, "coef", f32, (1 + 2 * n_store,), dev)
    if partials is not None:
        hs._require(partials, "partials", torch.float64,
                    (num_partials(like, order), 1 + 2 * n_store), dev)
    kind, dn, dt, _mass, _sig, vshift, absorb, *where, r0, r1 = hs.launch_geometry(
        analytic, grid, (nx, ny, nz), origin, red, KINDS, "complex analytic potential")
    if analytic is None:
        hs._require(b2, "b2", f32, (2, nx, ny, nz), dev)
    if done is not None:
        hs.require_done(done, dev)
    fn = _build.library().wafer_sweep_step_sc
    args = (
        None if analytic is not None else b2.data_ptr(),
        None if store is None else store.data_ptr(),
        coef.data_ptr(),
        None if partials is None else partials.data_ptr(),
        nx, ny, nz, ext, n_store, int(apply_coef), float(scale),
        kind, *where, dn, dt, vshift, absorb, r0, r1,
        None if done is None else done.data_ptr(), hs.stream_handle(dev, stream),
    )

    name = hs.route(True, n_store, False)

    def launch(src: torch.Tensor, dst: torch.Tensor) -> None:
        code = hs.on_device(dev, fn, src.data_ptr(), dst.data_ptr(), *args)
        hs._raise_if_failed(name, code)
        hs.LAUNCHES[name] += 1

    launch.tensors = (coef, partials, b2, store, done)
    return launch


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
    done: Optional[torch.Tensor] = None,
    graphs=None,
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
    modified. A batch's flag ``done`` and a solve's ``graphs`` as in
    :func:`hopper_stencil.evolve_chunk` (the steps run on a
    :class:`PairChunk`)."""
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    scale = dt / (k * dn * dn * mass)
    if analytic is None and b2 is None:
        raise ValueError("evolve_chunk_sc needs either analytic or b2")

    def make():
        return PairChunk(pair, order, scale, analytic=analytic, b=b2, store=store,
                         per_step_norm=per_step_norm, done=done)

    if graphs is None or done is not None:
        return chunk_graph.run(make(), pair, n_steps)
    key = ("K3", order, tuple(pair.shape), pair.device, scale, per_step_norm,
           *hs.store_key(store), *hs.b_key(analytic, b2))
    return graphs.run(key, make, pair, n_steps)


class PairChunk(hs.DeviceChunk):
    """:class:`hopper_stencil.DeviceChunk` for (re, im) pairs: K3, two
    reductions a stored pair, the split chunk's last correction."""

    components = 2
    bind = staticmethod(bind_sweep_sc)
    rows = staticmethod(num_partials)
    b_name = "b2"

    @staticmethod
    def finish_chunk(src, coef, store, per_step_norm):
        return finish_chunk_sc(src, coef, store, per_step_norm)


def finish_chunk_sc(src, coef, store, per_step_norm: bool) -> torch.Tensor:
    """The last step's pending correction ψ·inv − Σₛ(crₛ + i·ciₛ)·lₛ applied
    to the pair the sweep wrote (ψ·inv for per-step-norm, ψ for ground)."""
    if store is not None and store.shape[0] > 0:
        cr, ci = coef[1::2], coef[2::2]
        lr, li = store[:, 0], store[:, 1]
        re = src[0] * coef[0] - (torch.tensordot(cr, lr, dims=1) - torch.tensordot(ci, li, dims=1))
        im = src[1] * coef[0] - (torch.tensordot(cr, li, dims=1) + torch.tensordot(ci, lr, dims=1))
        return torch.stack([re, im])
    if per_step_norm:
        return src * coef[0]
    return src
