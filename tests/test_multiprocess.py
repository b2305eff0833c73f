"""Two-PROCESS distribution test (BASELINE config 5, VERDICT r1 missing #8).

The 8-virtual-device single-process mesh (tests/test_dist.py) cannot
exercise the cross-process collective path.  Here two actual OS processes
(4 virtual CPU devices each) are stitched together with
``jax.distributed.initialize`` and run the SAME sharded inverse-rendering
step over the global 8-device mesh; both must report the identical loss and
grad sums as the single-process 8-device reference.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(600)
def test_two_process_grads_match_single_process():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "mp_worker.py"),
             str(port), str(pid), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=540)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        outs.append(json.loads(line))

    # Both processes see the same replicated loss/grads.
    assert outs[0]["loss"] == pytest.approx(outs[1]["loss"], rel=1e-6)
    for k in outs[0]["grad_sums"]:
        assert outs[0]["grad_sums"][k] == pytest.approx(
            outs[1]["grad_sums"][k], rel=1e-5, abs=1e-10), k

    # And they match the single-process 8-device reference.
    from tpu_pt.bvh.native import build_packed
    from tpu_pt.config import RenderConfig
    from tpu_pt.diff.params import split
    from tpu_pt.dist.sharding import loss_and_grad_sharded, make_mesh
    from tpu_pt.scene import cornell
    import jax

    scene = cornell.cornell("empty")
    bvh = build_packed(scene)
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=1, rr_start=9)
    cam = cornell.camera(cfg.width, cfg.height)
    key = jax.random.key(2)
    params, _ = split(scene)
    target = np.zeros((cfg.n_pixels, 3), np.float32)
    mesh = make_mesh(8)
    loss, grads = loss_and_grad_sharded(
        params, scene, cam, cfg, key, target, bvh, mesh,
        queue=64, backend="packed")
    assert float(loss) == pytest.approx(outs[0]["loss"], rel=1e-5)
    for k, g in grads.items():
        assert float(np.asarray(g).sum()) == pytest.approx(
            outs[0]["grad_sums"][k], rel=1e-4, abs=1e-9), k
