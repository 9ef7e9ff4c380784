"""jet_pbrt_tpu — a differentiable Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference CPU
renderer JettHuang/jet-pbrt (C++17). This is NOT a
port: virtual-dispatch object graphs, per-hit heap BSDFs, recursive pointer
BVHs and stateful mt19937 samplers are replaced by SoA device arrays, masked
divergence-free kernels, a flattened skip-link BVH traversed with
`lax.while_loop`, and counter-based (threefry) random streams — the mapping
of a wavefront path tracer onto XLA's static-shape compilation model. It
runs on one NVIDIA GPU, on several through `parallel/`, and on the CPU.

Layout
------
ops/       batched compute kernels: linalg, sampling warps, RNG streams,
           ray-shape intersection, BVH traversal, BSDFs, microfacets, lights,
           textures
models/    camera, film, integrators (debug / Whitted / path)
scene/     scene builder API, packed device scene (ScenePack), OBJ ingestion,
           authored reference scenes (cornell box, bunny)
parallel/  device-mesh sharded rendering + gradient training (shard_map/psum)
diff/      differentiable-rendering parameter handling + gradient checks
utils/     image writers (PPM/BMP/HDR), device checks and compile cache,
           logging, checkpointing, the native-library bridge
"""

__version__ = "0.1.0"
