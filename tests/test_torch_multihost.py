"""PyTorch port, several processes: ``parallel.ShardedCanny`` over a
``torch.distributed`` process group (gloo on the CPU), its blocks spread
over the ranks.

* four ranks, one block each, a 1x2x2 mesh on a 64x128 frame: every rank's
  blocks bit-equal to the in-process mesh and to the golden model, in both
  hysteresis modes, with the halos and the flood's changed count going
  between processes;
* the counterpart of ``tests/test_multihost.py`` (``slow``, as JAX's): two
  ranks of four blocks each, the global 2x2x2 mesh with its data axis
  across the ranks, ``aggregate_stats`` and ``host_local_stream_config``.

This file is also the worker: ``python tests/test_torch_multihost.py MODE
RANK WORLD PORT OUT``.  Every subprocess has a time limit, so a hung
collective fails the test instead of the run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (64, 128)
TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _frames(n, shape=SHAPE):
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (n,) + shape, np.uint8)
    imgs[:, shape[0] // 3, 5:-5] = 250      # an edge across every block
    return imgs


def _spawn(mode, world, tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(world), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} rc={rc}\nstdout:{out}\nstderr:{err}"
        assert "RANK OK" in out, f"rank {rank}\nstdout:{out}\nstderr:{err}"
    return [o[1] for o in outs]


def _gather(tmp_path, world, name, shape):
    out = np.full(shape, -1, np.int32)
    for rank in range(world):
        got = np.load(os.path.join(tmp_path, f"{name}_{rank}.npz"))
        for key in got.files:
            b0, b1, r0, r1, c0, c1 = (int(v) for v in key.split("_"))
            out[b0:b1, r0:r1, c0:c1] = got[key]
    return out


def test_four_gloo_ranks_equal_in_process_mesh(tmp_path):
    from canny_edge_tpu import golden
    from canny_edge_tpu_torch.parallel import ShardedCanny, make_mesh

    _spawn("blocks", 4, tmp_path)
    imgs = _frames(1)
    for mode, oracle in (("component", golden.hysteresis),
                         ("strict-reference", golden.hysteresis_bfs)):
        got = _gather(tmp_path, 4, mode, (1,) + SHAPE)
        local = ShardedCanny(make_mesh([torch.device("cpu")] * 4, y=2, x=2),
                             1.0, SHAPE, hysteresis_mode=mode)
        np.testing.assert_array_equal(got, local(imgs, 30, 90).numpy())
        nm = golden.nonmax_suppression(*golden.sobel(
            golden.gaussian_blur(imgs[0], 1.0)))
        np.testing.assert_array_equal(got[0], oracle(nm, 30, 90))


@pytest.mark.slow
def test_two_process_global_mesh(tmp_path):
    from canny_edge_tpu import golden

    outs = _spawn("global", 2, tmp_path)
    imgs = _frames(4, (66, 98))
    got = _gather(tmp_path, 2, "global", imgs.shape)
    for i in range(4):
        np.testing.assert_array_equal(got[i], golden.canny(imgs[i], 1.0, 30, 90))
    assert all("agg_frames=4" in o for o in outs)


def _worker(mode, rank, world, port, out_dir):
    from canny_edge_tpu_torch.parallel import multihost
    from canny_edge_tpu_torch.parallel.sharded import ShardedCanny
    from canny_edge_tpu_torch.parallel.streaming import StreamStats

    got = multihost.initialize(f"localhost:{port}", world, rank, device="cpu")
    assert got == (rank, world), got

    def save(name, result):
        arrays = {}
        for (bs, rs, cs), t in result.local_shards():
            key = f"{bs.start}_{bs.stop}_{rs.start}_{rs.stop}_{cs.start}_{cs.stop}"
            arrays[key] = t.numpy()
        np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), **arrays)

    if mode == "blocks":
        mesh = multihost.global_mesh(data=1, y=2, x=2)
        assert mesh.shape == {"data": 1, "y": 2, "x": 2}
        assert mesh.local_blocks == [(0, rank // 2, rank % 2)]
        for hmode in ("component", "strict-reference"):
            model = ShardedCanny(mesh, 1.0, SHAPE, hysteresis_mode=hmode)
            assert model.engine == "static"
            save(hmode, model(_frames(1), 30, 90))
    else:
        # four blocks a rank, the data axis across the two ranks
        mesh = multihost.global_mesh(data=world, y=2, x=2,
                                     devices=[torch.device("cpu")] * 4)
        assert len(mesh.local_blocks) == 4
        assert {b[0] for b in mesh.local_blocks} == {rank}
        imgs = _frames(2 * world, (66, 98))
        model = ShardedCanny(mesh, 1.0, (66, 98))
        save("global", model(imgs, 30, 90))
        cfg = multihost.host_local_stream_config(8)
        assert (cfg.host_id, cfg.num_hosts) == (rank, world)
        stats = StreamStats(frames=2, batches=1, mp=2 * 66 * 98 / 1e6,
                            seconds=1.0)
        agg = multihost.aggregate_stats(stats)
        assert agg["hosts"] == world and agg["frames"] == 2 * world, agg
        assert abs(agg["mp"] - world * 2 * 66 * 98 / 1e6) < 1e-9, agg
        print(f"agg_frames={agg['frames']}")
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"RANK OK {rank}", flush=True)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5])
