#!/usr/bin/env python
"""Chip smoke test: the renderer's main path on an NVIDIA GPU, checked.

    python chip_smoke.py          # one GPU: phases 1-6
    python chip_smoke.py --four   # four GPUs: the sharded frame only

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: JAX platform, device kind and count; the card's name and power
     limit from nvidia-smi. Anything but a GPU stops here.
  2. bunny 1024^2, 4 spp, depth 5, NEE, through `jet_pbrt_tpu.cli.main`:
     compile and steady seconds, estimator rays/s; a finite, non-black image.
  3. Cornell box 512^2, 8 spp, through the CLI: the same.
  4. inverse rendering: three `diff.params.fit` steps on Cornell 128^2 at
     4 spp; the mat_c0 gradient is non-zero and matches a central finite
     difference at the same seed.
  5. plain references at real widths: (a) the BVH walk against brute force
     over every bunny-scene triangle; (b) exact table lookups and (c) the
     converged goldens, by running those tests on the card.
  6. the per-phase split of one bunny wave (scripts/wave_profile.py).
  7. (--four only) the bunny 1024^2 8 spp frame sharded over a (px=2,
     spp=2) mesh of four GPUs against the one-GPU render at the same seed.

Everything runs in this one process (a JAX process reserves most of the
card's memory). Images and stats go to smoke_out/ (gitignored). The last
line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")

# Tolerances, each with its reason:
# - walk vs brute force, valid flag: the two evaluate Moller-Trumbore from
#   differently rounded inputs (instance-local vs world space; stored edges
#   vs p1 - p0; rects as planes vs two triangles), so rays grazing an edge
#   may flip. At most 1 ray in 10^4.
VALID_AGREE = 0.9999
# - t where both hit: float32 rounding through the instance transform.
T_RTOL = 1e-4
# - gradient vs central difference: tests/test_grad.py's albedo check.
GRAD_RTOL, GRAD_ATOL, FD_EPS = 5e-2, 1e-4, 1e-3
# - four-card frame vs one-card frame: the same per-lane arithmetic; only
#   the order of the spp sum differs (float32 psum vs float64 host sum).
SHARD_REL = 1e-4


def phase(name):
    print(f"\n=== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"    ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def device_phase():
    t0 = phase("1. device")
    import jax
    from jet_pbrt_tpu.utils import device

    device.require_gpu()
    device.enable_compile_cache()
    dev = device.describe_devices()
    card = device.card_name_and_power_limit()
    print(f"    jax {jax.__version__}: {dev}")
    print(f"    card (name, power limit): {card}")
    done(t0)
    return dev, card


def cli_phase(label, argv, card):
    t0 = phase(f"{label} through jet_pbrt_tpu.cli.main {' '.join(argv)}")
    from jet_pbrt_tpu import cli

    name = label.split()[1]
    stats_path = os.path.join(OUT, f"{name}.json")
    rc = cli.main(argv + ["--platform", "gpu", "--out",
                          os.path.join(OUT, name), "--stats", stats_path])
    check(rc == 0, f"cli exited {rc}")
    with open(stats_path) as f:
        st = json.load(f)
    check(st["device"]["platform"] == "gpu", st["device"])
    check(st["image_finite"], "image has non-finite pixels")
    check(st["image_mean"] > 1e-3, f"image is black: {st['image_mean']}")
    check(st["rays"] > 0, "no estimator rays counted")
    print(f"    [{card}] compile {st['compile_s']:.2f} s (first call "
          f"{st['first_call_s']:.2f} s), steady {st['steady_s']:.3f} s for "
          f"{st['steady_calls']} wave calls, {st['rays_per_s']:.6g} "
          f"estimator rays/s (primary {st['rays_primary']:.0f}, bounce "
          f"{st['rays_bounce']:.0f}, shadow {st['rays_shadow']:.0f}); image "
          f"mean {st['image_mean']:.4f} -> {st['image']}")
    done(t0)


def fit_phase(size=128, spp=4):
    t0 = phase(f"4. fit: 3 steps on Cornell {size}^2, {spp} spp")
    import jax
    from jet_pbrt_tpu.diff import params as P
    from jet_pbrt_tpu.models.render import render_fn
    from jet_pbrt_tpu.scene.scenes import cornell_box

    # depth 2: no russian roulette, so the image is smooth in mat_c0
    fn, pack = render_fn(cornell_box(), size, size, spp, seed=0,
                         max_depth=2)
    target = jax.jit(fn)(pack)
    start = pack._replace(mat_c0=pack.mat_c0 * 0.8 + 0.05)
    params, losses = P.fit(fn, start, target, fields=("mat_c0",), steps=3,
                           lr=0.05)
    print(f"    losses {losses}")
    check(all(np.isfinite(losses)), "non-finite loss")
    loss = jax.jit(P.loss_fn(fn, start, target))
    p0 = P.get_params(start, ("mat_c0",))
    g = np.asarray(jax.jit(jax.grad(loss))(p0)["mat_c0"], np.float64)
    i, c = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    check(abs(g[i, c]) > GRAD_ATOL, f"mat_c0 gradient is ~zero: {g}")
    base = np.asarray(p0["mat_c0"])

    def at(delta):
        m = base.copy()
        m[i, c] += delta
        return float(loss({"mat_c0": jax.numpy.asarray(m)}))

    fd = (at(FD_EPS) - at(-FD_EPS)) / (2 * FD_EPS)
    rel = abs(g[i, c] - fd) / max(abs(fd), GRAD_ATOL / GRAD_RTOL)
    print(f"    d loss / d mat_c0[{i},{c}]: autodiff {g[i, c]:.6g}, "
          f"central difference {fd:.6g}, rel err {rel:.3g} "
          f"(limit {GRAD_RTOL})")
    check(rel < GRAD_RTOL, "gradient does not match finite difference")
    done(t0)


def walk_phase(n=65536):
    t0 = phase(f"5a. walk vs brute force: {n} camera + {n} random rays, "
               "bunny scene")
    import jax
    import jax.numpy as jnp
    from jet_pbrt_tpu.models import camera as camera_mod
    from jet_pbrt_tpu.scene import pack as scene_pack
    from jet_pbrt_tpu.scene.scenes import bunny_scene
    from walk_reference import brute_force, world_triangles

    scene = bunny_scene()
    meta, pack = scene.meta, scene.pack
    rng = np.random.default_rng(0)
    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (1024, 1024))
    px = rng.uniform(0, 1024, (n, 2)).astype(np.float32)
    o_cam, d_cam = camera_mod.generate_rays(cam, jnp.asarray(px))
    c, r = np.asarray(pack.world_center), float(pack.world_radius)
    o_rnd = rng.uniform(c - r, c + r, (n, 3)).astype(np.float32)
    d_rnd = rng.normal(size=(n, 3))
    d_rnd = (d_rnd / np.linalg.norm(d_rnd, axis=1, keepdims=True))
    o = jnp.concatenate([o_cam, jnp.asarray(o_rnd)])
    d = jnp.concatenate([d_cam, jnp.asarray(d_rnd, jnp.float32)])
    m = 2 * n
    tmin = jnp.full((m,), pack.ray_eps)
    tmax = jnp.full((m,), jnp.inf)

    hit = jax.jit(lambda o, d: scene_pack.intersect(
        meta, pack, o, d, tmin, tmax))(o, d)
    far = o + (4.0 * r) * d
    occ = np.asarray(jax.jit(lambda a, b: scene_pack.occluded(
        meta, pack, a, b))(o, far))
    valid, t = np.asarray(hit.valid), np.asarray(hit.t)
    tris = world_triangles(scene)
    ref_valid, ref_t = brute_force(o, d, tmin, tmax, tris)
    agree = float((valid == ref_valid).mean())
    both = valid & ref_valid
    t_err = float(np.max(np.abs(t[both] - ref_t[both])
                         / np.maximum(np.abs(ref_t[both]), 1e-30)))
    occ_agree = float((occ == valid).mean())
    print(f"    {len(tris)} world triangles; hits: walk {valid.mean():.4f}, "
          f"brute force {ref_valid.mean():.4f}; valid agreement {agree:.6f} "
          f"(limit {VALID_AGREE}); max rel t error {t_err:.3g} (limit "
          f"{T_RTOL}); occluded() vs closest-hit agreement {occ_agree:.6f}")
    check(agree >= VALID_AGREE, "walk and brute force disagree on hits")
    check(t_err <= T_RTOL, "walk and brute force disagree on t")
    check(occ_agree >= VALID_AGREE, "occluded() disagrees with intersect()")
    done(t0)


class _Outcomes:
    """pytest plugin: counts test outcomes (a skip counts against us)."""

    def __init__(self):
        self.counts = collections.Counter()

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def pytest_phase():
    t0 = phase("5b/5c. exact lookups, no gemm, converged goldens: tests on "
               "the card")
    import pytest

    os.environ["JET_CHIP_TESTS"] = "1"
    outcomes = _Outcomes()
    tests = ["tests/test_lookups.py",
             "tests/test_golden.py::test_cornell_self_golden_tight",
             "tests/test_golden.py::test_bunny_self_golden_structure"]
    rc = pytest.main(["-q", "-rA", "--durations=0", "-p", "no:cacheprovider",
                      "--rootdir", ROOT] + [os.path.join(ROOT, t)
                                            for t in tests],
                     plugins=[outcomes])
    print(f"    pytest exit {rc}: {dict(outcomes.counts)}")
    check(rc == 0 and outcomes.counts["passed"] == 9
          and set(outcomes.counts) == {"passed"},
          "chip tests did not all pass")
    done(t0)


def profile_phase(card, width=1024, reps=3):
    t0 = phase(f"6. per-phase split of one bunny wave, {width}^2 [{card}]")
    import wave_profile

    rows = wave_profile.profile(width, reps,
                                log=lambda s: print("    " + s, flush=True))
    check(rows and all(np.isfinite(dt) for _, dt in rows), "no timings")
    done(t0)


def four_phase(card, size=1024, spp=8):
    t0 = phase(f"7. bunny {size}^2 {spp} spp sharded over 4 GPUs "
               f"(px=2, spp=2) [{card}]")
    import jax
    from jet_pbrt_tpu.models import camera as camera_mod
    from jet_pbrt_tpu.models.render import render
    from jet_pbrt_tpu.parallel.mesh import make_mesh
    from jet_pbrt_tpu.parallel.render import build_sharded_render
    from jet_pbrt_tpu.scene.scenes import bunny_scene

    check(len(jax.devices()) == 4, f"need 4 GPUs: {jax.devices()}")
    scene = bunny_scene()
    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (size, size))
    # render_sharded's own program, kept as a device array so that its
    # placement can be checked
    fn = build_sharded_render(scene.meta, make_mesh(px=2, spp=2), size,
                              size, spp, seed=0)
    t1 = time.perf_counter()
    flat = jax.block_until_ready(fn(scene.pack, cam))
    first = time.perf_counter() - t1
    t1 = time.perf_counter()
    flat = jax.block_until_ready(fn(scene.pack, cam))
    steady = time.perf_counter() - t1
    devices = flat.sharding.device_set
    print(f"    first call {first:.2f} s (compile included), steady "
          f"{steady:.3f} s per frame; film on {len(devices)} devices")
    check(len(devices) == 4, f"film on {devices}")
    img4 = np.asarray(flat).reshape(size, size, 3)
    t1 = time.perf_counter()
    # stats={} compiles the same wave program as the CLI's bunny render
    img1 = render(scene, size, size, spp, seed=0, clamp=False, stats={})
    print(f"    one-GPU render: {time.perf_counter() - t1:.2f} s "
          "(compile included)")
    rel = float(np.abs(img4 - img1).mean() / np.abs(img1).mean())
    print(f"    mean |four - one| / mean |one| = {rel:.3g} "
          f"(limit {SHARD_REL})")
    check(np.isfinite(img4).all() and img1.mean() > 1e-3, "bad image")
    check(rel < SHARD_REL, "sharded frame differs from one-GPU frame")
    done(t0)


def main(argv) -> int:
    four = "--four" in argv
    os.makedirs(OUT, exist_ok=True)
    sys.path[:0] = [os.path.join(ROOT, "tests"),
                    os.path.join(ROOT, "scripts")]
    dev, card = device_phase()
    if four:
        four_phase(card)
    else:
        check(dev["count"] == 1, f"run with one GPU visible: {dev}")
        cli_phase("2. bunny 1024^2 4 spp", ["1", "4", "--size", "1024"],
                  card)
        cli_phase("3. cornell 512^2 8 spp", ["0", "8", "--size", "512"],
                  card)
        fit_phase()
        walk_phase()
        pytest_phase()
        profile_phase(card)
    print(f"\ncard: {card}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
