"""One rank of the gloo checks in tests/test_torch_dp.py.

Run as ``python tests/_torch_dist_worker.py RANK WORLD STORE OUT`` with
``PYTHONPATH=src``, one process a rank: joins a gloo group through the
file store STORE (every collective bounded by a timeout), runs the
communicator's collectives on seeded inputs (``inputs``), a compressed
psum in chunks of one block, and two compressed data-parallel steps of reduced
qwen2-0.5b (``dp_setup``), and writes this rank's results to OUT (npz).
Imports torch and the port only. The test builds the same inputs with
the functions here and runs them on a ``VirtualMesh``.
"""
import sys

import numpy as np
import torch

N_RANKS = 4
TIMEOUT = 60.0                  # seconds, every collective of the group
DTYPES = {"float32": np.float32, "int32": np.int32, "int64": np.int64}
COLLECTIVES = ("psum", "pmax", "pmin", "psum_scatter", "all_gather",
               "all_to_all")
DP_STEPS = 2


def inputs(rank: int):
    """{dtype name: this rank's (8, 5) input}: floats of mixed scale with
    exact ties across ranks, and integers."""
    rng = np.random.RandomState(100 + rank)
    f = (rng.randn(8, 5) * np.exp(rng.randn(8, 5) * 3)).astype(np.float32)
    f[0] = np.float32(0.1) * (rank + 1)      # sums that round
    f[1, 0] = -0.0 if rank % 2 else 0.0      # signed zeros for max / min
    return {"float32": f,
            "int32": rng.randint(-1000, 1000, (8, 5)).astype(np.int32),
            "int64": rng.randint(-1 << 40, 1 << 40, (8, 5)).astype(np.int64)}


def chunked_inputs(rank: int):
    """{layout: this rank's float32 input to a chunked psum}: (5, 8)
    transposed from (8, 5), and (8, 5) row-major."""
    f = torch.from_numpy(inputs(rank)["float32"])
    return {"transposed": f.t(), "contiguous": f}


def grads(rank: int):
    """A compressed psum's inputs on this rank: (grads, residuals)."""
    rng = np.random.RandomState(200 + rank)
    g = {"a": (rng.randn(40, 64) * 1e-3).astype(np.float32),
         "b": {"c": (rng.randn(3, 700) * np.exp(rng.randn(3, 700))
                     ).astype(np.float32)}}
    e = {"a": (rng.randn(40, 64) * 1e-5).astype(np.float32),
         "b": {"c": (rng.randn(3, 700) * 1e-2).astype(np.float32)}}
    return g, e


def tree(x):
    if isinstance(x, dict):
        return {k: tree(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def flat(x, prefix=""):
    if isinstance(x, dict):
        out = {}
        for k in sorted(x):
            out.update(flat(x[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): x.detach().numpy()}


def dp_setup():
    """(model, cfg, params, opt state, batches) of the compressed DP run:
    reduced qwen2-0.5b from the port's seeded init, 8 x 16 tokens."""
    from repro_torch.configs.reduced import REDUCED
    from repro_torch.core.config import (LM_SHAPES, RunConfig,
                                         ShardingConfig, TrainConfig)
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.lm import LMModel
    from repro_torch.optim import adamw
    arch = REDUCED["qwen2-0.5b"]
    model = LMModel(arch, remat="none", device="cpu")
    cfg = RunConfig(arch=arch, shape=LM_SHAPES["train_4k"],
                    sharding=ShardingConfig(gradient_compression=True),
                    train=TrainConfig(learning_rate=1e-3, warmup_steps=1))
    params = model.init_params(seed=5)
    batches = [tree(synth_batch(arch, 8, 16, step=s, seed=5))
               for s in range(DP_STEPS)]
    return model, cfg, params, adamw.init(params, cfg.train), batches


def main(rank: int, world: int, store_path: str, out_path: str) -> None:
    import torch.distributed as dist
    from repro_torch.core import dist as tdist
    from repro_torch.optim import compression
    from repro_torch.runtime.dp_step import (init_error_feedback,
                                             make_dp_train_step)
    torch.set_num_threads(1)
    out = {}
    with tdist.process_group("gloo", rank=rank, world_size=world,
                             store=dist.FileStore(store_path, world),
                             timeout=TIMEOUT) as mesh:
        comm = mesh.comm
        for name, x in inputs(rank).items():
            for op in COLLECTIVES:
                out[f"{op}/{name}"] = getattr(comm, op)(
                    torch.from_numpy(x)).numpy()
        # float psums in chunks: a transposed input a row (8 floats) at a
        # time, a contiguous one 3 values at a time
        chunk_bytes, tdist.CHUNK_BYTES = tdist.CHUNK_BYTES, 12
        for name, x in chunked_inputs(rank).items():
            got = comm.psum(x)
            out[f"chunked/{name}"] = got.numpy()
            out[f"chunked/{name}/stride"] = np.array(got.stride())
        tdist.CHUNK_BYTES = chunk_bytes
        try:
            comm.all_to_all(torch.zeros(5, 2))
        except ValueError as e:
            out["ragged_error"] = np.array(str(e))
        g, e = grads(rank)
        errors = tree(e)
        chunk, compression.CHUNK_BLOCKS = compression.CHUNK_BLOCKS, 1
        synced, _ = compression.compressed_psum(tree(g), comm, errors)
        compression.CHUNK_BLOCKS = chunk
        out.update({f"cp/synced/{k}": v for k, v in flat(synced).items()})
        out.update({f"cp/errors/{k}": v for k, v in flat(errors).items()})

        model, cfg, params, opt, batches = dp_setup()
        step = make_dp_train_step(model, cfg, mesh, total_steps=DP_STEPS)
        errs = init_error_feedback(params, mesh)
        for s, b in enumerate(batches):
            params, opt, errs, m = step(params, opt, errs, b, s)
            out[f"dp/loss{s}"] = m["loss"].numpy()
        out.update({f"dp/params/{k}": v for k, v in flat(params).items()})
        out.update({f"dp/errors/{k}": v for k, v in flat(errs).items()})
        out["traffic"] = np.array(repr(sorted(comm.traffic.items())))
    np.savez(out_path, **out)




if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
