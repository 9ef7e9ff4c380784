"""Distributed gradient-descent fitting of scene parameters (inverse
rendering) over the device mesh.

The forward render is the shard_map program of parallel/render.py; because
scene parameters are replicated across the mesh, jax.grad through shard_map
produces gradients that XLA all-reduces automatically — the
overlapped gradient all-reduce of the BASELINE north star without a single
hand-written collective.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models import camera as camera_mod
from ..diff import params as P
from .render import build_sharded_render


def build_train_step(scene, mesh, width: int, height: int, spp: int,
                     fields=("mat_c0",), lr: float = 1.0, seed: int = 0,
                     max_depth: int = 2):
    """Returns (step, init) where step(params, target_flat) ->
    (params', loss). target_flat: [H*W, 3]."""
    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (width, height),
    )
    render = build_sharded_render(scene.meta, mesh, width, height, spp,
                                  seed=seed, max_depth=max_depth)
    pack = scene.pack

    def loss_fn(params, target_flat):
        img = render(P.with_params(pack, params), cam)
        return jnp.mean((img - target_flat) ** 2)

    @jax.jit
    def step(params, target_flat):
        loss, g = jax.value_and_grad(loss_fn)(params, target_flat)
        new = {k: jnp.maximum(params[k] - lr * g[k], 0.0) for k in params}
        return new, loss

    def init():
        return P.get_params(pack, fields)

    return step, init, render, cam
