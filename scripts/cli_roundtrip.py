"""CLI round-trip through the public CLI, recorded as one JSON capture.

SURVEY.md §3 notes the reference repo has no train()/serve() — this script
is the proof the new framework does, end to end through the public CLI
(`python -m phys_autodiff_tpu`), one scripted run:

    train -> serve(grid) -> serve(points) -> simulate(obstacles+emitter)
          -> fit(on the served snapshot) -> serve(points, fitted model)
          -> export(npz -> vtk)

Each stage runs as a real subprocess of the CLI (argv in, files out), its
wall time and key output facts are recorded, and the capture lands in
build/cli_roundtrip/cli_roundtrip.json. The stages run one after another and
this parent process never imports JAX, so only one process at a time holds
the accelerator.

    PYTHONPATH=.:$PYTHONPATH python scripts/cli_roundtrip.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

WORK = "build/cli_roundtrip"


def run(stage, args, capture):
    cmd = [sys.executable, "-m", "phys_autodiff_tpu"] + args
    print(f"\n$ python -m phys_autodiff_tpu {' '.join(args)}", flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    tail = (r.stdout + r.stderr).strip().splitlines()[-6:]
    for line in tail:
        print("  |", line, flush=True)
    ok = r.returncode == 0
    capture["stages"].append({
        "stage": stage, "argv": args, "rc": r.returncode,
        "wall_s": round(dt, 2), "tail": tail,
    })
    if not ok:
        raise RuntimeError(f"stage {stage} failed rc={r.returncode}")
    return dt


def main():
    os.makedirs(WORK, exist_ok=True)
    capture = {"stages": [], "work_dir": WORK}
    ck = f"{WORK}/model.npz"
    served = f"{WORK}/served.npz"
    pts = f"{WORK}/points.npy"
    pts_out = f"{WORK}/points_eval.npy"
    sim = f"{WORK}/smoke"
    fit_ck = f"{WORK}/fitted.npz"
    fit_pts_out = f"{WORK}/fit_points_eval.npy"
    vtk = f"{WORK}/served.vtk"

    # 1. train: physics-residual training on the real chip
    run("train", [
        "train", "--grid", "64x64x64", "--family", "mlp", "--hidden", "64",
        "--steps", "300", "--lr", "3e-3", "--seed", "1", "--out", ck,
    ], capture)
    # 2. serve the trained model on its full grid
    run("serve-grid", ["serve", "--ckpt", ck, "--t", "0.25", "--out", served],
        capture)
    # 3. serve at arbitrary points
    rng = np.random.default_rng(0)
    np.save(pts, rng.uniform(size=(4096, 3)).astype(np.float32))
    run("serve-points", [
        "serve", "--ckpt", ck, "--t", "0.25", "--points", pts,
        "--out", pts_out,
    ], capture)
    out = np.load(pts_out)
    assert out.shape[0] == 4096 and np.all(np.isfinite(out)), out.shape
    print(f"  point eval ok: {out.shape}, sigma range "
          f"[{out[:, 0].min():.3f}, {out[:, 0].max():.3f}]", flush=True)
    # 4. simulate: Euler smoke seeded from the model, with a solid obstacle
    #    and an emitter (masked-CGNR projection path)
    run("simulate", [
        "simulate", "--ckpt", ck, "--frames", "4", "--steps-per-frame", "3",
        "--obstacle", "sphere:32,32,32:0.15",
        "--emitter", "4,28,28:10,36,36:2.0",
        "--out", sim,
    ], capture)
    frames = [f for f in os.listdir(WORK) if f.startswith("smoke")]
    assert frames, "simulate produced no VTK frames"
    print(f"  simulate ok: {len(frames)} files", flush=True)
    # 5. fit a FRESH field to the served snapshot (supervised fit engine;
    # the hash-NGP family — the fitter built for detail, fit-ladder rows)
    run("fit", [
        "fit", "--target", served, "--family", "ngp",
        "--steps", "300", "--lr", "3e-3", "--seed", "2", "--out", fit_ck,
    ], capture)
    # 6. serve the fitted model at the same points
    run("fit-serve-points", [
        "serve", "--ckpt", fit_ck, "--t", "0.25", "--points", pts,
        "--out", fit_pts_out,
    ], capture)
    out2 = np.load(fit_pts_out)
    assert out2.shape == out.shape and np.all(np.isfinite(out2))
    # the fitted field approximates the served one: point evals correlate
    rel = float(np.linalg.norm(out2 - out) / np.linalg.norm(out))
    capture["fit_vs_trained_point_rel"] = round(rel, 4)
    print(f"  fitted-vs-trained point-eval rel: {rel:.4f}", flush=True)
    # 7. export the served snapshot to VTK
    run("export", ["export", "--input", served, "--out", vtk], capture)
    assert os.path.exists(vtk)

    capture["total_wall_s"] = round(
        sum(s["wall_s"] for s in capture["stages"]), 2
    )
    path = os.path.join(WORK, "cli_roundtrip.json")
    with open(path, "w") as f:
        f.write(json.dumps(capture, indent=1) + "\n")
    print(f"wrote {path}", flush=True)
    print(f"\nround-trip OK: {len(capture['stages'])} stages, "
          f"{capture['total_wall_s']}s total")
    return 0


if __name__ == "__main__":
    sys.exit(main())
