#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):

1. Card, versions, and the build of ``wafer_torch/csrc`` with nvcc.
2. Each CUDA kernel against its plain torch version on the card: orders
   3/5/7 × analytic B for the five potential kinds and streamed B × 0, 1
   or 2 stored states × identity and non-identity coefficients, on a
   64×64×128 grid, plus one 256³ case. Tolerances (f32 reordering):
   ψ' ≤ 1e-6·max|ψ'|; ‖ψ'‖² ≤ 1e-5 relative; ⟨l|ψ'⟩ ≤ 1e-5 of ‖l‖·‖ψ'‖.
3. 500-step ground, per-step-norm and excited (S = 1) chunks at 256³
   through the kernels and through the plain torch ops, timed with CUDA
   events; ψ ≤ 1e-4·max|ψ| and ‖ψ‖² ≤ 1e-4 relative after 500 steps.
4. The main path: ``wafer_torch.cli.main`` on a 256³ f32 Harmonic config,
   ground and first excited state, |E − oracle| < 5e-3, with launch
   counters showing that the kernels ran and the plain sweep did not.

The complex-ψ slice adds, for the CUDA pair sweep K3 (re, im pairs):

2b. K3 (and K2 on its 1 + 2S partials) against the plain versions:
    orders 3/5/7 × ComplexHarmonic and ComplexCoulomb analytic B and
    streamed (Br, Bi) × S = 0, 1, 2 × identity and non-identity
    coefficients on 64×64×128, plus one 256³ case; the tolerances of 2.
3b. 500-step 256³ complex chunks (ground analytic, ground streamed,
    per-step-norm, excited S = 1), kernel against the plain split ops;
    the tolerances of 3.
4b. The complex main path through ``wafer_torch.cli.main``: a 256³
    ComplexHarmonic run (absorb 0.2) with E₀ and E₁ within 5e-3 of
    (n + 3/2)·√(1 + 0.2i) in Re and in Im, and
    ``examples/complex_cornell.yaml`` as it stands (ComplexFullCornell
    256³, streamed B), which must converge with Im E > 0 and Im/Re within
    20 % of 0.2. K3 must launch and the plain split sweep must not run.

Each main-path run resets the launch counters just before it and reads
them just after. Prints the card's name and power limit, a JSON line of
the chunk timings, a JSON line of per-kernel results, and as its last
line the device summary JSON.
"""

import cmath
import json
import os
import subprocess
import sys
import tempfile
import time


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def padded_noise(shape, ext, gen, dev):
    import torch
    import torch.nn.functional as F

    return F.pad(torch.randn(shape, generator=gen, device=dev), (ext,) * 6)


def analytic_for(kind, n):
    """(kind, dn, dt, mass, nx, ny, nz, sig, vshift) with sensible physics."""
    if kind == "SimpleCornell":
        return (kind, 0.35, 0.004, 4.65, *n, 0.223, 18.0)
    return (kind, 0.2, 0.004, 1.0, *n, 1.0, 0.0)


def kernel_vs_plain(order, kind, n_store, identity, n, gen, dev):
    """One K1 + K2 case on the card against the plain versions.
    Returns (ψ' abs err, ψ' rel err, reduction rel err, K2 abs err)."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_stencil as hs

    ext = geometry.EXT[order]
    psi = padded_noise(n, ext, gen, dev)
    store = None
    if n_store:
        store = torch.stack([padded_noise(n, ext, gen, dev) for _ in range(n_store)])
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3), keepdim=True))
    analytic = b_int = None
    if kind == "streamed":
        b_int = (1.0 / (1.0 + 0.002 * torch.rand(n, generator=gen, device=dev))).contiguous()
    else:
        analytic = analytic_for(kind, n)
    coef = torch.zeros(1 + n_store, device=dev)
    coef[0] = 1.0
    if not identity:
        coef = torch.tensor([0.9] + [0.05 * (s + 1) for s in range(n_store)], device=dev)
    apply = n_store > 0 or not identity  # ground mode: no correction, no sums
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    scale = 0.004 / (k * 0.2 * 0.2)
    kw = dict(order=order, scale=scale, analytic=analytic, b_int=b_int, store=store,
              apply_coef=apply)
    out_k, out_p = torch.empty_like(psi), torch.empty_like(psi)
    part_k = part_p = None
    if apply:
        part_k = torch.empty(hs.num_partials(psi, order), 1 + n_store,
                             dtype=torch.float64, device=dev)
        part_p = torch.empty(1, 1 + n_store, dtype=torch.float64, device=dev)
    hs.sweep_step(psi, out_k, coef, part_k, **kw)
    hs.sweep_step_plain(psi, out_p, coef, part_p, **kw)
    torch.cuda.synchronize()
    psi_abs = (out_k - out_p).abs().max().item()
    psi_rel = psi_abs / out_p.abs().max().item()
    red_rel = k2_abs = 0.0
    if apply:
        red_k = torch.empty(1 + n_store, dtype=torch.float64, device=dev)
        red_p, red_q = torch.empty_like(red_k), torch.empty_like(red_k)
        c_k, c_p = torch.empty_like(coef), torch.empty_like(coef)
        hs.finish_coef(part_k, red_k, c_k)
        hs.finish_coef_plain(part_p, red_p, c_p)
        hs.finish_coef_plain(part_k, red_q, c_p)  # same partials, plain order
        torch.cuda.synchronize()
        n2 = red_p[0].item()
        scale_s = [n2] + [n2 ** 0.5] * n_store  # ‖l_s‖ = 1
        red_rel = max(abs(a - b) / s for a, b, s in zip(red_k.tolist(), red_p.tolist(), scale_s))
        k2_abs = (red_k - red_q).abs().max().item()
    return psi_abs, psi_rel, red_rel, k2_abs


def pair_kernel_vs_plain(order, kind, n_store, identity, n, gen, dev):
    """One K3 + K2 case on the card against the plain versions. Returns
    (ψ' abs err, ψ' rel err, reduction rel err, K2 abs err)."""
    import torch

    from wafer_torch import geometry
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs

    ext = geometry.EXT[order]

    def pair():
        return torch.stack([padded_noise(n, ext, gen, dev) for _ in range(2)])

    psi = pair()
    store = None
    if n_store:
        store = torch.stack([pair() for _ in range(n_store)])
        store = store / torch.sqrt((store * store).sum(dim=(1, 2, 3, 4), keepdim=True))
    analytic = b2 = None
    if kind == "streamed":
        d = 1.0 + 0.002 * torch.rand(n, generator=gen, device=dev)
        di = 0.0004 * torch.rand(n, generator=gen, device=dev)
        mag = d * d + di * di
        b2 = torch.stack([d / mag, -di / mag]).contiguous()
    else:
        analytic = (kind, 0.2, 0.004, 1.0, *n, 1.0, 0.0, 0.2)
    n_red = 1 + 2 * n_store
    coef = torch.zeros(n_red, device=dev)
    coef[0] = 1.0
    if not identity:
        coef = torch.tensor([0.9] + [0.05 * (s + 1) for s in range(2 * n_store)], device=dev)
    apply = n_store > 0 or not identity
    _o, _c, _cc, k = geometry.stencil_coefficients(order)
    scale = 0.004 / (k * 0.2 * 0.2)
    kw = dict(order=order, scale=scale, analytic=analytic, b2=b2, store=store, apply_coef=apply)
    out_k, out_p = torch.empty_like(psi), torch.empty_like(psi)
    part_k = part_p = None
    if apply:
        part_k = torch.empty(hsp.num_partials(psi, order), n_red, dtype=torch.float64, device=dev)
        part_p = torch.empty(1, n_red, dtype=torch.float64, device=dev)
    hsp.sweep_step_sc(psi, out_k, coef, part_k, **kw)
    hsp.sweep_step_sc_plain(psi, out_p, coef, part_p, **kw)
    torch.cuda.synchronize()
    psi_abs = (out_k - out_p).abs().max().item()
    psi_rel = psi_abs / out_p.abs().max().item()
    red_rel = k2_abs = 0.0
    if apply:
        red_k = torch.empty(n_red, dtype=torch.float64, device=dev)
        red_p, red_q = torch.empty_like(red_k), torch.empty_like(red_k)
        c_k, c_p = torch.empty_like(coef), torch.empty_like(coef)
        hs.finish_coef(part_k, red_k, c_k)
        hs.finish_coef_plain(part_p, red_p, c_p)
        hs.finish_coef_plain(part_k, red_q, c_p)  # same partials, plain order
        torch.cuda.synchronize()
        n2 = red_p[0].item()
        scale_s = [n2] + [n2 ** 0.5] * (2 * n_store)  # ‖l_s‖ = 1
        red_rel = max(abs(a - b) / s for a, b, s in zip(red_k.tolist(), red_p.tolist(), scale_s))
        k2_abs = (red_k - red_q).abs().max().item()
    return psi_abs, psi_rel, red_rel, k2_abs


def harmonic_state(n, dn, gen, dev, odd=False):
    """Smooth padded test state: the oscillator ground (or its x-odd
    partner) plus 1% noise, ThreePoint shell."""
    import torch
    import torch.nn.functional as F

    x = (torch.arange(n, device=dev, dtype=torch.float32) - (n - 1) / 2.0) * dn
    r2 = x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2
    w = torch.exp(-r2 / 2.0) * (x[:, None, None] if odd else 1.0)
    w = w + 0.01 * torch.randn(w.shape, generator=gen, device=dev)
    w = F.pad(w, (1,) * 6)
    return (w / torch.sqrt((w * w).sum())).contiguous()


def main_path(config_text):
    """Run ``wafer_torch.cli.main`` on ``config_text`` in a temporary
    directory. Returns (energies E/‖ψ‖², complex for a complex potential,
    [(SolveResult, wall seconds)], kernel launches, plain-sweep calls, wall
    seconds); launches and plain calls are counted from just before the
    run. Each state's observables file must hold Re E."""
    import yaml

    from wafer_torch import cli, solver
    from wafer_torch.ops import hopper_split as hsp, hopper_stencil as hs, split_complex, stencil

    plain_calls = [0]

    def counted(fn):
        def wrapper(*args, **kwargs):
            plain_calls[0] += 1
            return fn(*args, **kwargs)
        return wrapper

    states = []
    orig_solve = solver.solve

    def timed_solve(*args, **kwargs):
        t = time.perf_counter()
        res = orig_solve(*args, **kwargs)  # ends on a host read of its scalars
        states.append((res, time.perf_counter() - t))
        return res

    patched = [(m, n, getattr(m, n)) for m, n in
               ((stencil, "evolve_step"), (hs, "sweep_step_plain"), (hs, "finish_coef_plain"),
                (split_complex, "evolve_step_sc"), (hsp, "sweep_step_sc_plain"))]
    n_states = yaml.safe_load(config_text)["wavemax"] + 1
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="wafer_torch_smoke_") as tmp:
        os.chdir(tmp)
        try:
            with open("smoke.yaml", "w") as fh:
                fh.write(config_text)
            for mod, name, fn in patched:
                setattr(mod, name, counted(fn))
            solver.solve = timed_solve
            hs.reset_launches()
            t = time.perf_counter()
            rc = cli.main(["-c", "smoke.yaml"])
            wall = time.perf_counter() - t
            launches = dict(hs.LAUNCHES)
        finally:
            solver.solve = orig_solve
            for mod, name, fn in patched:
                setattr(mod, name, fn)
            os.chdir(cwd)
        check(rc == 0, f"cli.main returned {rc}")
        (run_dir,) = os.listdir(os.path.join(tmp, "output"))
        energies = [res.observables.energy / res.observables.norm2 for res, _s in states]
        check(len(energies) == n_states, f"{len(energies)} of {n_states} states solved")
        for wnum, e in enumerate(energies):
            path = os.path.join(tmp, "output", run_dir, f"observables_{wnum}.json")
            check(os.path.exists(path), f"observables_{wnum}.json was not written")
            with open(path) as fh:
                written = float(json.load(fh)["energy"])
            check(abs(written - e.real) <= 1e-9 * abs(e.real), f"state {wnum}: file E {written}")
    return energies, states, launches, plain_calls[0], wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from wafer_torch import geometry
    from wafer_torch.models import potentials
    from wafer_torch.ops import _build, hopper_stencil as hs, stencil

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.library()
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s: {_build.build().name}")
    for line in _build.build().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip())

    # ---------------------------------------------------------------- 2
    gen = torch.Generator(device=dev).manual_seed(1234)
    kinds = ["NoPotential", "Harmonic", "Coulomb", "SimpleCornell", "Periodic", "streamed"]
    worst = [0.0, 0.0, 0.0, 0.0]
    n_cases = 0
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for kind in kinds:
            for n_store in (0, 1, 2):
                for identity in (True, False):
                    errs = kernel_vs_plain(order, kind, n_store, identity, (64, 64, 128), gen, dev)
                    check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                          f"{order} {kind} S={n_store} identity={identity}: {errs}")
                    worst = [max(a, b) for a, b in zip(worst, errs)]
                    n_cases += 1
    big = kernel_vs_plain("ThreePoint", "Harmonic", 1, False, (256, 256, 256), gen, dev)
    check(big[1] <= 1e-6 and big[2] <= 1e-5, f"256^3 case: {big}")
    worst = [max(a, b) for a, b in zip(worst, big)]
    print(f"[2] {n_cases + 1} kernel-vs-plain cases: max psi' err {worst[0]:.3e} abs "
          f"({worst[1]:.3e} of max|psi'|, tol 1e-6), max reduction err {worst[2]:.3e} "
          f"(tol 1e-5), K2 vs plain sum on the same partials {worst[3]:.3e} abs")

    # per-launch times at the main path's shape (256³ ThreePoint Harmonic)
    n3 = (256, 256, 256)
    psi = harmonic_state(256, 0.0375, gen, dev)
    out = torch.empty_like(psi)
    an = ("Harmonic", 0.0375, 4e-4, 1.0, *n3, 1.0, 0.0)
    scale = 4e-4 / (2.0 * 0.0375 ** 2)
    coef = torch.tensor([1.0, 0.0], device=dev)
    store = psi[None].clone()
    part = torch.empty(hs.num_partials(psi, "ThreePoint"), 2, dtype=torch.float64, device=dev)
    part1 = torch.empty(1, 2, dtype=torch.float64, device=dev)
    red = torch.empty(2, dtype=torch.float64, device=dev)
    cf = torch.empty(2, device=dev)
    kw = dict(order="ThreePoint", scale=scale, analytic=an)
    sweep_ms = cuda_ms(lambda: hs.sweep_step(psi, out, coef[:1], None, **kw), 200)
    sweep_plain_ms = cuda_ms(lambda: hs.sweep_step_plain(psi, out, coef[:1], None, **kw), 20)
    sweep_exc_ms = cuda_ms(lambda: hs.sweep_step(psi, out, coef, part, store=store,
                                                 apply_coef=True, **kw), 200)
    sweep_exc_plain_ms = cuda_ms(lambda: hs.sweep_step_plain(psi, out, coef, part1, store=store,
                                                             apply_coef=True, **kw), 20)
    finish_ms = cuda_ms(lambda: hs.finish_coef(part, red, cf), 200)
    finish_plain_ms = cuda_ms(lambda: hs.finish_coef_plain(part, red, cf), 200)
    print(f"    256^3 per launch: sweep_step ground {sweep_ms:.4f} ms (plain {sweep_plain_ms:.4f}),"
          f" S=1 {sweep_exc_ms:.4f} ms (plain {sweep_exc_plain_ms:.4f}),"
          f" finish_coef {finish_ms:.4f} ms over {part.shape[0]} partials"
          f" (plain {finish_plain_ms:.4f})")

    # ---------------------------------------------------------------- 2b
    from wafer_torch.ops import hopper_split as hsp, split_complex

    worst_sc = [0.0, 0.0, 0.0, 0.0]
    n_cases = 0
    for order in ("ThreePoint", "FivePoint", "SevenPoint"):
        for kind in ("Harmonic", "Coulomb", "streamed"):
            for n_store in (0, 1, 2):
                for identity in (True, False):
                    errs = pair_kernel_vs_plain(order, kind, n_store, identity, (64, 64, 128),
                                                gen, dev)
                    check(errs[1] <= 1e-6 and errs[2] <= 1e-5,
                          f"K3 {order} {kind} S={n_store} identity={identity}: {errs}")
                    worst_sc = [max(a, b) for a, b in zip(worst_sc, errs)]
                    n_cases += 1
    big = pair_kernel_vs_plain("ThreePoint", "Harmonic", 1, False, (256, 256, 256), gen, dev)
    check(big[1] <= 1e-6 and big[2] <= 1e-5, f"K3 256^3 case: {big}")
    worst_sc = [max(a, b) for a, b in zip(worst_sc, big)]
    print(f"[2b] {n_cases + 1} pair-kernel-vs-plain cases: max psi' err {worst_sc[0]:.3e} abs "
          f"({worst_sc[1]:.3e} of max|psi'|, tol 1e-6), max reduction err {worst_sc[2]:.3e} "
          f"(tol 1e-5), K2 (n_red = 1+2S) vs plain sum on the same partials "
          f"{worst_sc[3]:.3e} abs")

    # per-launch times at the complex main path's shape (256³ ThreePoint,
    # ComplexHarmonic dn 0.0625, dt 1.2e-3, absorb 0.2)
    dn_c, dt_c, absorb = 0.0625, 1.2e-3, 0.2
    an_c = ("Harmonic", dn_c, dt_c, 1.0, *n3, 1.0, 0.0, absorb)
    vr = 0.5 * (dn_c * dn_c) * geometry.r2_index_grid((258,) * 3, n3, torch.float32, dev)
    ar, ai, br, bi = potentials.build_ab_split(vr, absorb * vr, dt_c)
    b2 = geometry.work_area(torch.stack([br, bi]), 1).contiguous()
    del vr
    pair = torch.stack([harmonic_state(256, dn_c, gen, dev),
                        0.1 * harmonic_state(256, dn_c, gen, dev)])
    out_c = torch.empty_like(pair)
    store_c = pair[None].clone()
    coef_c = torch.tensor([1.0, 0.0, 0.0], device=dev)
    part_c = torch.empty(hsp.num_partials(pair, "ThreePoint"), 3, dtype=torch.float64, device=dev)
    part1_c = torch.empty(1, 3, dtype=torch.float64, device=dev)
    kwc = dict(order="ThreePoint", scale=dt_c / (2.0 * dn_c ** 2))
    sc_times = {}
    for name, kw_case in (
        ("ground analytic", dict(analytic=an_c)),
        ("ground streamed", dict(b2=b2)),
        ("S=1 analytic", dict(analytic=an_c, store=store_c, apply_coef=True)),
    ):
        k_part, p_part, cf = (part_c, part1_c, coef_c) if "store" in kw_case else (None, None,
                                                                                   coef_c[:1])
        sc_times[name] = (
            cuda_ms(lambda: hsp.sweep_step_sc(pair, out_c, cf, k_part, **kw_case, **kwc), 200),
            cuda_ms(lambda: hsp.sweep_step_sc_plain(pair, out_c, cf, p_part, **kw_case, **kwc), 20),
        )
    print("     256^3 per launch: " + ", ".join(
        f"sweep_step_sc {k} {t[0]:.4f} ms (plain {t[1]:.4f})" for k, t in sc_times.items()))

    # ---------------------------------------------------------------- 3
    dn, dt, su = 0.0375, 4e-4, 500
    v = 0.5 * (dn * dn) * geometry.r2_index_grid((258,) * 3, n3, torch.float32, dev)
    a, b = potentials.build_ab(v, dt)
    ground = harmonic_state(256, dn, gen, dev)
    excited = harmonic_state(256, dn, gen, dev, odd=True)
    store = ground[None].contiguous()
    chunk_rows = []
    for name, phi0, psn, st in (("ground", ground, False, None),
                                ("per-step-norm", ground, True, None),
                                ("excited S=1", excited, False, store)):
        def run_kernel():
            return hs.evolve_chunk(phi0, "ThreePoint", dt, dn, 1.0, su, an,
                                   per_step_norm=psn, store=st)

        def run_plain():
            return stencil.evolve_chunk(phi0, a, b, st, "ThreePoint", dt, dn, 1.0, su,
                                        0 if st is None else 1, per_step_norm=psn)

        k_ms = cuda_ms(run_kernel, 1)
        p_ms = cuda_ms(run_plain, 1)
        out_k, out_p = run_kernel(), run_plain()
        torch.cuda.synchronize()
        dpsi = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        n_k, n_p = (out_k * out_k).double().sum().item(), (out_p * out_p).double().sum().item()
        dn2 = abs(n_k - n_p) / n_p
        check(dpsi <= 1e-4 and dn2 <= 1e-4, f"{name} chunk deviates: psi {dpsi:.3e} norm2 {dn2:.3e}")
        chunk_rows.append({"chunk": name, "kernel_ms_per_step": k_ms / su,
                           "plain_ms_per_step": p_ms / su, "psi_rel_dev": dpsi,
                           "norm2_rel_dev": dn2})
        print(f"[3] {name:13s} 500 steps at 256^3: kernel {k_ms / su:.4f} ms/step, plain "
              f"{p_ms / su:.4f} ms/step; psi dev {dpsi:.3e}, norm2 dev {dn2:.3e} (tol 1e-4)")
    del v, a, b, ground, excited, store

    # ---------------------------------------------------------------- 3b
    g0 = torch.stack([harmonic_state(256, dn_c, gen, dev),
                      0.1 * harmonic_state(256, dn_c, gen, dev)])
    e1 = torch.stack([harmonic_state(256, dn_c, gen, dev, odd=True),
                      0.1 * harmonic_state(256, dn_c, gen, dev, odd=True)])
    store_g = (g0 / torch.sqrt((g0 * g0).sum()))[None].contiguous()
    for name, phi0, psn, st, streamed in (("ground", g0, False, None, False),
                                          ("ground streamed", g0, False, None, True),
                                          ("per-step-norm", g0, True, None, False),
                                          ("excited S=1", e1, False, store_g, False)):
        def run_kernel():
            return hsp.evolve_chunk_sc(phi0, "ThreePoint", dt_c, dn_c, 1.0, su,
                                       None if streamed else an_c, per_step_norm=psn, store=st,
                                       b2=b2 if streamed else None)

        def run_plain():
            lr = li = None
            if st is not None:
                lr, li = st[:, 0], st[:, 1]
            return torch.stack(split_complex.evolve_chunk_sc(
                phi0[0], phi0[1], ar, ai, br, bi, lr, li, "ThreePoint", dt_c, dn_c, 1.0, su,
                0 if st is None else 1, per_step_norm=psn))

        k_ms = cuda_ms(run_kernel, 1)
        p_ms = cuda_ms(run_plain, 1)
        out_k, out_p = run_kernel(), run_plain()
        torch.cuda.synchronize()
        dpsi = ((out_k - out_p).abs().max() / out_p.abs().max()).item()
        n_k, n_p = (out_k * out_k).double().sum().item(), (out_p * out_p).double().sum().item()
        dn2 = abs(n_k - n_p) / n_p
        check(dpsi <= 1e-4 and dn2 <= 1e-4,
              f"complex {name} chunk deviates: psi {dpsi:.3e} norm2 {dn2:.3e}")
        chunk_rows.append({"chunk": f"complex {name}", "kernel_ms_per_step": k_ms / su,
                           "plain_ms_per_step": p_ms / su, "psi_rel_dev": dpsi,
                           "norm2_rel_dev": dn2})
        print(f"[3b] {name:15s} 500 steps at 256^3: kernel {k_ms / su:.4f} ms/step, plain "
              f"{p_ms / su:.4f} ms/step; psi dev {dpsi:.3e}, norm2 dev {dn2:.3e} (tol 1e-4)")
    del ar, ai, br, bi, b2, pair, out_c, store_c, g0, e1, store_g

    # ---------------------------------------------------------------- 4
    energies, states, launches, plain_calls, wall = main_path(MAIN_PATH_CONFIG)
    for (wnum, oracle), e in zip(((0, 1.5), (1, 2.5)), energies):
        check(abs(e - oracle) < 5e-3, f"state {wnum}: E = {e}, oracle {oracle}")
    check(launches["sweep_step"] > 0 and launches["finish_coef"] > 0,
          f"the main path did not launch every kernel: {launches}")
    check(plain_calls == 0, f"the plain sweep ran {plain_calls} times on the main path")
    n_points = 256 ** 3
    for (res, secs), e in zip(states, energies):
        print(f"[4] state {res.wnum}: E = {e:.6f}, {res.steps} steps, wall {secs:.2f} s, "
              f"chunks {res.chunk_seconds:.2f} s of device time = "
              f"{n_points * res.steps / res.chunk_seconds:.4g} grid-point updates/s")
    print(f"[4] cli.main 256^3 two states: {wall:.2f} s wall; launches {launches}; "
          f"plain sweep calls {plain_calls}")

    # ---------------------------------------------------------------- 4b
    runs = {"real harmonic": launches}
    e_c, states_c, launches_c, plain_c, wall_c = main_path(COMPLEX_HARMONIC_CONFIG)
    for wnum, e in enumerate(e_c):
        oracle = (wnum + 1.5) * cmath.sqrt(1 + 0.2j)
        check(abs(e.real - oracle.real) < 5e-3 and abs(e.imag - oracle.imag) < 5e-3,
              f"complex harmonic state {wnum}: E = {e}, oracle {oracle}")
    check(launches_c["sweep_step_sc"] > 0 and launches_c["finish_coef"] > 0,
          f"the complex harmonic path did not launch every kernel: {launches_c}")
    check(plain_c == 0, f"the plain sweeps ran {plain_c} times on the complex harmonic path")
    runs["complex harmonic"] = launches_c
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "complex_cornell.yaml")) as fh:
        cornell = fh.read()
    e_k, states_k, launches_k, plain_k, wall_k = main_path(cornell)
    (e,) = e_k
    check(states_k[0][0].converged and e.imag > 0.0
          and abs(e.imag - 0.2 * e.real) / abs(e.real) < 0.2,
          f"complex_cornell.yaml: E = {e}")
    check(launches_k["sweep_step_sc"] > 0, f"complex_cornell.yaml launched no K3: {launches_k}")
    check(plain_k == 0, f"the plain sweeps ran {plain_k} times on complex_cornell.yaml")
    runs["complex cornell"] = launches_k
    for tag, sts, es in (("harmonic", states_c, e_c), ("cornell", states_k, e_k)):
        for (res, secs), e in zip(sts, es):
            print(f"[4b] complex {tag} state {res.wnum}: E = {e.real:.6f} {e.imag:+.6f}i, "
                  f"{res.steps} steps, wall {secs:.2f} s, chunks {res.chunk_seconds:.2f} s of "
                  f"device time = {n_points * res.steps / res.chunk_seconds:.4g} "
                  f"grid-point updates/s")
    print(f"[4b] cli.main 256^3 complex harmonic two states: {wall_c:.2f} s wall; launches "
          f"{launches_c}; complex_cornell.yaml: {wall_k:.2f} s wall; launches {launches_k}; "
          f"plain sweep calls {plain_c + plain_k}")
    total = {k: sum(r[k] for r in runs.values()) for k in launches}

    # ---------------------------------------------------------------- 5
    print(json.dumps({"chunks": chunk_rows}))
    source = "wafer_torch/csrc/stencil_sweep.cu"
    print(json.dumps({"kernels": [
        {"name": "sweep_step", "route": "cuda", "source": source,
         "replaces": "wafer_tpu/ops/pallas_stencil.py:167",
         "launches": total["sweep_step"], "max_abs_err": worst[0],
         "ms": sweep_ms, "plain_ms": sweep_plain_ms},
        {"name": "finish_coef", "route": "cuda", "source": source,
         "replaces": "wafer_tpu/ops/pallas_stencil.py:2234",
         "launches": total["finish_coef"], "max_abs_err": max(worst[3], worst_sc[3]),
         "ms": finish_ms, "plain_ms": finish_plain_ms},
        {"name": "sweep_step_sc", "route": "cuda", "source": "wafer_torch/csrc/split_sweep.cu",
         "replaces": "wafer_tpu/ops/pallas_split.py:179",
         "launches": total["sweep_step_sc"], "max_abs_err": worst_sc[0],
         "ms": sc_times["ground analytic"][0], "plain_ms": sc_times["ground analytic"][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# 256³ f32 Harmonic, the 9.6-wide box of examples/harmonic_excited.yaml
MAIN_PATH_CONFIG = """\
project_name: smoke harmonic 256
grid:
  size: {x: 256, y: 256, z: 256}
  dn: 0.0375
  dt: 0.0004
tolerance: 1.0e-5
central_difference: ThreePoint
max_steps: 200000
wavenum: 0
wavemax: 1
output:
  screen_update: 500
  snap_update: null
  file_type: Json
  save_wavefns: false
  save_potential: false
potential: Harmonic
mass: 1.0
init_condition: Constant
sig: 1.0
init_symmetry: NotConstrained
precision: f32
seed: 7
"""


# 256³ f32 ComplexHarmonic (absorb 0.2) in a 16-wide box (dn 0.0625); dt
# 1.2e-3 is 92 % of the ThreePoint bound dn²·m/3
COMPLEX_HARMONIC_CONFIG = """\
project_name: smoke complex harmonic 256
grid:
  size: {x: 256, y: 256, z: 256}
  dn: 0.0625
  dt: 0.0012
tolerance: 1.0e-5
central_difference: ThreePoint
max_steps: 200000
wavenum: 0
wavemax: 1
output:
  screen_update: 500
  snap_update: null
  file_type: Json
  save_wavefns: false
  save_potential: false
potential: ComplexHarmonic
absorb: 0.2
mass: 1.0
init_condition: Constant
sig: 1.0
init_symmetry: NotConstrained
precision: f32
seed: 7
"""


if __name__ == "__main__":
    sys.exit(main())
