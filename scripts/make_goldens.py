#!/usr/bin/env python
"""Regenerate the committed self-golden renders under tests/golden/.

Run on a GPU (seconds) or the CPU (minutes). The goldens are
SELF-consistency oracles: a converged render of each authored scene at a
fixed seed, against which the test suite asserts tight statistical
tolerances (tests/test_golden.py). They complement — not replace — the
structural comparison against the reference's own cornell JPEG, which can
only be loose because of the documented camera-fov divergence
(models/camera.py). Regenerate ONLY after an intentional light-transport
change, and re-run the structural reference comparison afterwards.
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "golden")


def main():
    from jet_pbrt_tpu.scene.scenes import cornell_box, bunny_scene
    from jet_pbrt_tpu.models.render import render

    os.makedirs(OUT, exist_ok=True)

    # cornell: 48x48, 32k spp, maxdepth 5 — 64x the test render's spp, so
    # the test tolerance is dominated by the test render's own noise.
    # (The backend matters little: renders of this config agree to float
    # rounding — same threefry decisions, same f32 path.)
    img = np.asarray(
        render(cornell_box(), 48, 48, spp=32768, seed=1234, max_depth=5)
    )
    np.savez_compressed(
        os.path.join(OUT, "cornell_self_48.npz"),
        img=img.astype(np.float32), spp=32768, seed=1234, max_depth=5,
    )
    print("cornell golden mean", img.mean())

    # bunny: 64x64, 1024 spp — the structural oracle for the instanced
    # TLAS/BLAS + env-light path (reference scene: src/main.cc:64-111).
    img = np.asarray(
        render(bunny_scene(), 64, 64, spp=1024, seed=1234, max_depth=5)
    )
    np.savez_compressed(
        os.path.join(OUT, "bunny_self_64.npz"),
        img=img.astype(np.float32), spp=1024, seed=1234, max_depth=5,
    )
    print("bunny golden mean", img.mean())

    # fast-tier exact-seed smoke golden: 16x16 / 8 spp on CPU — committed
    # so the DEFAULT test tier (pytest -m "not slow") catches estimator
    # regressions per-iteration without waiting for the converged goldens.
    # MUST be generated on CPU (tests/conftest.py forces the CPU backend
    # for the default tier, and the comparison is near-bitwise).
    import jax
    if jax.default_backend() != "cpu":
        print("skipping fast smoke golden (needs the CPU backend)")
        return
    img = np.asarray(
        render(cornell_box(), 16, 16, spp=8, seed=42, max_depth=5)
    )
    np.savez_compressed(
        os.path.join(OUT, "cornell_smoke_16.npz"),
        img=img.astype(np.float32), spp=8, seed=42, max_depth=5,
    )
    print("cornell smoke golden mean", img.mean())


if __name__ == "__main__":
    main()
