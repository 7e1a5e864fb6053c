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

Prints the card's name and power limit, a JSON line of the chunk
timings, a JSON line of per-kernel results, and as its last line the
device summary JSON.
"""

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
    directory. Returns (energies from observables_*.json, [(SolveResult,
    wall seconds)], kernel launches, plain-sweep calls, wall seconds);
    launches and plain calls are counted from just before the run."""
    import yaml

    from wafer_torch import cli, solver
    from wafer_torch.ops import hopper_stencil as hs, stencil

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
               ((stencil, "evolve_step"), (hs, "sweep_step_plain"), (hs, "finish_coef_plain"))]
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
        energies = []
        for wnum in range(n_states):
            path = os.path.join(tmp, "output", run_dir, f"observables_{wnum}.json")
            check(os.path.exists(path), f"observables_{wnum}.json was not written")
            with open(path) as fh:
                energies.append(float(json.load(fh)["energy"]))
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

    # ---------------------------------------------------------------- 5
    print(json.dumps({"chunks": chunk_rows}))
    source = "wafer_torch/csrc/stencil_sweep.cu"
    print(json.dumps({"kernels": [
        {"name": "sweep_step", "route": "cuda", "source": source,
         "replaces": "wafer_tpu/ops/pallas_stencil.py:167",
         "launches": launches["sweep_step"], "max_abs_err": worst[0],
         "ms": sweep_ms, "plain_ms": sweep_plain_ms},
        {"name": "finish_coef", "route": "cuda", "source": source,
         "replaces": "wafer_tpu/ops/pallas_stencil.py:2234",
         "launches": launches["finish_coef"], "max_abs_err": worst[3],
         "ms": finish_ms, "plain_ms": finish_plain_ms},
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


if __name__ == "__main__":
    sys.exit(main())
