"""One rank of a ``torch.distributed`` cohort on the CPU (gloo), for the
port's multi-process tests (``tests/test_torch_parallel.py``).

    python tests/_torch_dist_worker.py --scenario S --rank R --world N \\
        --port P --dir D

imports torch and the port only, joins the cohort at
``tcp://127.0.0.1:P`` and runs one scenario on inputs the test wrote to
``D/in.pt``; rank R writes its results to ``D/rank<R>.pt``:

- ``attention``: ring (flash and einsum bodies) and Ulysses attention,
  causal and not, the two decode forms and the indivisible-heads error,
  on a mesh given by ``--mesh`` (``seq=4`` or ``data=2,seq=2``);
- ``dp``: ``make_dp_train_step`` over ``{"data": N}`` on each rank's
  rows of the given global batches (``--local-batch-stats``: batch
  norm's moments left local to each rank, the negative control;
  ``--device cuda --backend gloo``: every rank on the card);
- ``gang``: the resnet-train job (``functions/train_cell.py:run_resnet``)
  on each rank's partition with count-based checkpoints, then the same
  job in a fresh environment restored from checkpoint ``--restore-id``.
"""

import argparse
import contextlib
import os
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from flink_tensorflow_tpu_torch.functions import train_cell  # noqa: E402
from flink_tensorflow_tpu_torch.parallel import collectives, multihost  # noqa: E402
from flink_tensorflow_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def _mesh_axes(text: str):
    return {k: int(v) for k, v in (part.split("=") for part in text.split(","))}


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def attention(args, inputs):
    from flink_tensorflow_tpu_torch.parallel import (
        ring_attention,
        ring_decode_attention,
        ulysses_attention,
        ulysses_decode_attention,
    )

    mesh = make_mesh(_mesh_axes(args.mesh), devices=["cpu"])
    q, k, v = inputs["q"], inputs["k"], inputs["v"]
    out = {}
    for causal in (False, True):
        for impl in ("flash", "einsum"):
            collectives.calls.clear()
            out[f"ring_{impl}_{int(causal)}"] = ring_attention(mesh, q, k, v, causal=causal,
                                                               impl=impl)
            out[f"ring_{impl}_{int(causal)}_hops"] = collectives.calls["send_recv"]
            collectives.calls.clear()
            out[f"ulysses_{impl}_{int(causal)}"] = ulysses_attention(mesh, q, k, v,
                                                                     causal=causal, impl=impl)
            out[f"ulysses_{impl}_{int(causal)}_a2a"] = collectives.calls["all_to_all"]
    out["ring_decode"] = ring_decode_attention(mesh, inputs["qd"], inputs["kd"], inputs["vd"],
                                               inputs["lengths"])
    out["ulysses_decode"] = ulysses_decode_attention(mesh, inputs["qd"], inputs["kd"],
                                                     inputs["vd"], inputs["lengths"])
    bad = inputs["odd_heads"]
    for name, fn in (("ulysses", ulysses_attention), ("ulysses_decode", None)):
        try:
            if fn is not None:
                fn(mesh, bad, bad, bad, impl="einsum")
            else:
                ulysses_decode_attention(mesh, bad[:, :1], bad, bad, inputs["lengths"][:1])
            out[f"{name}_odd_heads_error"] = ""
        except ValueError as exc:
            out[f"{name}_odd_heads_error"] = str(exc)
    return out


def dp(args, inputs):
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.parallel import dp as port_dp
    from flink_tensorflow_tpu_torch.parallel.mesh import replicate, shard_batch
    from flink_tensorflow_tpu_torch.parallel.optim import sgd

    mesh = make_mesh({"data": args.world}, devices=[args.device])
    mdef = get_model_def(inputs["architecture"], **inputs["config"])
    opt = sgd(inputs["lr"])
    state = replicate(mesh, inputs["state"])
    step = port_dp.make_dp_train_step(mdef, opt, mesh)
    losses, counts = [], []
    with (train_cell.local_batch_statistics() if args.local_batch_stats
          else contextlib.nullcontext()):
        for i, batch in enumerate(inputs["batches"]):
            rows = next(iter(batch.values())).shape[0] // args.world
            mine = {k: v[args.rank * rows:(args.rank + 1) * rows] for k, v in batch.items()}
            collectives.calls.clear()
            state, metrics = step(state, shard_batch(mesh, mine), i)
            counts.append(dict(collectives.calls))
            losses.append(float(metrics["loss"]))
    return {"variables": _host(state["variables"]), "losses": losses, "calls": counts,
            "step": int(state["step"])}


def gang(args, inputs):
    from flink_tensorflow_tpu_torch.checkpoint.store import read_checkpoint
    from flink_tensorflow_tpu_torch.models.zoo.registry import get_model_def
    from flink_tensorflow_tpu_torch.tensors.value import TensorValue

    mesh = make_mesh({"data": args.world}, devices=["cpu"])
    mdef = get_model_def("resnet50", **inputs["config"])
    batch = inputs["global_batch"]
    records = [TensorValue({"image": image, "label": label}, {"id": i})
               for i, (image, label) in enumerate(zip(inputs["images"], inputs["labels"]))]
    mine = train_cell.partition(records, batch, args.rank, args.world)
    chk = os.path.join(args.dir, f"chk{args.rank}")

    def run(restore_id=None):
        run = train_cell.run_resnet(mdef, inputs["schema"], mine, mesh, batch=batch,
                                    checkpoint_dir=chk, every_n_records=inputs["every_n"],
                                    restore_id=restore_id, timeout=60)
        return ([(int(r["step"]), float(r["loss"])) for r in run.results],
                run.function.current_params())

    steps_a, params_a = run()
    _, snap = read_checkpoint(chk, args.restore_id)
    ckpt_step = int(snap["dp_train"][0]["function"]["state"]["step"])
    steps_b, params_b = run(args.restore_id)
    return {"steps_a": steps_a, "params_a": params_a, "steps_b": steps_b, "params_b": params_b,
            "checkpoint_step": ckpt_step, "num_processes": multihost.topology().num_processes}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", required=True, choices=("attention", "dp", "gang"))
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--mesh", default="seq=4")
    p.add_argument("--local-batch-stats", action="store_true")
    p.add_argument("--restore-id", type=int, default=1)
    p.add_argument("--device", default="cpu", help="dp: cuda shares the card between ranks")
    p.add_argument("--backend", default=None)
    args = p.parse_args()
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    topo = multihost.initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
                                device=args.device, backend=args.backend, timeout_s=60)
    assert topo.num_processes == args.world and topo.process_id == args.rank
    inputs = torch.load(os.path.join(args.dir, "in.pt"), weights_only=False)
    out = {"attention": attention, "dp": dp, "gang": gang}[args.scenario](args, inputs)
    torch.save(out, os.path.join(args.dir, f"rank{args.rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main()
