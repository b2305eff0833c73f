"""Multi-process distribution worker (SURVEY.md §4 item 5 / BASELINE
config 5): one of N processes computing the sharded inverse-rendering step
over the GLOBAL device mesh.

Launched by tests/test_multiprocess.py as:
    python tools/mp_worker.py <coordinator_port> <process_id> <num_processes>

Each process owns 4 virtual CPU devices; jax.distributed.initialize stitches
them into one 4N-device mesh, so the shard_map tile sharding + per-chunk
grad psums exercise the actual cross-process collective path (the closest a
single host gets to N>=2 hosts).  Prints one JSON line with the loss and a
grad checksum; the test asserts both processes agree with the single-process
reference.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert len(jax.devices()) == 4 * nproc, jax.devices()

    import jax.numpy as jnp
    import numpy as np

    from tpu_pt.bvh.native import build_packed
    from tpu_pt.config import RenderConfig
    from tpu_pt.diff.params import split
    from tpu_pt.dist.sharding import loss_and_grad_sharded, make_mesh
    from tpu_pt.scene import cornell

    scene = cornell.cornell("empty")
    bvh = build_packed(scene)
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=1, rr_start=9)
    cam = cornell.camera(cfg.width, cfg.height)
    key = jax.random.key(2)
    params, _ = split(scene)
    target = np.zeros((cfg.n_pixels, 3), np.float32)

    mesh = make_mesh()  # all 4*nproc global devices
    loss, grads = loss_and_grad_sharded(
        params, scene, cam, cfg, key, target, bvh, mesh,
        queue=64, backend="packed",
    )
    # Replicated outputs: every process can read its addressable shard.
    loss_v = float(np.asarray(jax.device_get(loss)))
    sums = {k: float(np.asarray(jax.device_get(g)).sum())
            for k, g in sorted(grads.items())}
    print(json.dumps({"process": pid, "loss": loss_v, "grad_sums": sums}),
          flush=True)


if __name__ == "__main__":
    main()
