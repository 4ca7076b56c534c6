"""CNN quantized-gradient training CLI (the ImageNet side-harness).

Port of the JAX package's train_cnn.py, its form of
`training_imagenet_speedup.py`'s argparse surface and main loop (:30-107,
:472-584): the quantized CNN family (`models/cnn.py`) trained data-parallel
under the top-k row-sparsified gradient all-reduce
(`parallel/topk_grad.py`), on the learnable class-conditional synthetic
images (no image dataset here); the distributed algorithm, the k schedule
and the metrics are the point of the harness, as in the reference.

    python -m deep_quantized_recommendation_model_dqrm_tpu_torch.train_cnn \
        --arch=32-64-128 --batch-size=256 --steps=200 --top-k=64 \
        --mode=gather --k-schedule=cifar10

One rank per process, as torchrun lays them out:

    torchrun --nproc-per-node=2 -m deep_quantized_recommendation_model_dqrm_tpu_torch.train_cnn ...

`multihost.init_distributed` joins the ranks from torchrun's environment
(one rank without it): NCCL on the card, gloo with `--platform=cpu`.
`--num-devices=0` means the group's world size; any other value must equal
it. Every rank draws the same global batches from `--seed` and trains on
its slice of each; only rank 0 prints.

Under drift each rank keeps its own params, as each device of JAX's
`shard_map` keeps its own copy. The JAX CLI's per-epoch Hessian trace runs
outside the `shard_map`: it comes out on device 0, computed from device 0's
params, and every device's step then scores its rows with that one trace;
its final eval runs each device on its own params and reads device 0's
back. So here rank 0 estimates the trace from its params and broadcasts it
to every rank, and the final eval reads rank 0's params, which rank 0
prints (the tests hold both against JAX's per-device shards).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List

import numpy as np
import torch

from deep_quantized_recommendation_model_dqrm_tpu_torch.device import resolve_device
from deep_quantized_recommendation_model_dqrm_tpu_torch.models import cnn
from deep_quantized_recommendation_model_dqrm_tpu_torch.parallel import multihost, topk_grad
from deep_quantized_recommendation_model_dqrm_tpu_torch.train import _device


def dash_ints(s: str) -> List[int]:
    return [int(x) for x in s.split("-")]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Quantized-gradient CNN training")
    # arch (the reference's -a/--arch picks a torchvision model; here the stack)
    p.add_argument("--arch", type=dash_ints, default=[32, 64, 128])
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--bits", type=int, default=8)
    p.add_argument("--no-quant", action="store_true")
    p.add_argument("--no-bn", action="store_true")
    # training (training_imagenet_speedup.py:40-60)
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--steps", type=int, default=200, help="total train steps")
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--wd", "--weight-decay", type=float, default=0.0, dest="wd")
    p.add_argument("-p", "--print-freq", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    # top-k sync (the reference's --top_k / --metric / get_k_value schedule)
    p.add_argument("--top-k", type=int, default=32)
    p.add_argument("--mode", choices=["mask", "gather"], default="mask")
    p.add_argument("--metric", choices=["norm", "hessian"], default="norm",
                   help="row scoring: grad-norm or Hutchinson-trace-weighted "
                        "(training_imagenet_speedup.py --metric)")
    p.add_argument("--hessian-samples", type=int, default=8)
    p.add_argument("--k-schedule", choices=["none", "cifar10", "imagenet"],
                   default="none")
    p.add_argument("--num-devices", type=int, default=0,
                   help="0 = the process group's world size (one rank per process)")
    p.add_argument("--platform", type=str, default="",
                   help="cpu, or gpu/cuda (the default: the card)")
    return p


def run(argv=None) -> dict:
    """The CLI's work; returns {"rc", and after training "state" (this
    rank's `TopKState`), "losses" (the mean loss of every step, float32 on
    the device), "synced" (Melem a step), "top1", "scores0" (the scores
    after step 0, which chose its rows), "trace" (the last epoch's Hessian
    trace weights under --metric=hessian, else None)}."""
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    device = _device(args.platform)
    dev = resolve_device(device)  # no card and no --platform=cpu: raises
    created = not dist.is_initialized()
    # a group the caller made is used as it is, whatever its backend (two
    # gloo ranks may share one card)
    rank, world = multihost.init_distributed(device=dev) if created else multihost.world()
    try:
        return _run(args, dev, rank, world, dist.get_backend())
    finally:
        if created:  # a group the caller made stays the caller's
            multihost.shutdown()


def _run(args, dev: torch.device, rank: int, world: int, backend: str) -> dict:
    cfg = cnn.CNNConfig(
        image_size=args.image_size,
        channels=tuple(args.arch),
        num_classes=args.num_classes,
        bits=args.bits,
        quantize=not args.no_quant,
        batch_norm=not args.no_bn,
    )
    ndev = args.num_devices or world
    if ndev != world:
        print(f"--num-devices={ndev} needs a process group of {ndev} ranks; this one has {world}",
              file=sys.stderr)
        return {"rc": 2}
    if args.batch_size % ndev != 0:
        print(f"batch size {args.batch_size} not divisible by {ndev} devices", file=sys.stderr)
        return {"rc": 2}

    params = cnn.init_cnn_params(cfg, args.seed, dev)
    state = topk_grad.init_topk_state(params, ndev)
    rs = np.random.RandomState(args.seed)

    def loss_fn(p, batch):
        imgs, labels = batch
        return cnn.cross_entropy_loss(cnn.cnn_forward(cfg, p, imgs, train=True), labels)

    total_epochs = max(1, args.steps // args.steps_per_epoch)
    t0 = time.perf_counter()
    loss = mb = None
    trace = None
    losses, synced = [], []
    for i in range(args.steps):
        epoch = i // args.steps_per_epoch
        k = args.top_k
        if args.k_schedule != "none":
            k = topk_grad.get_k_value(args.top_k, epoch, total_epochs, args.k_schedule)
        if args.metric == "hessian" and i % args.steps_per_epoch == 0:
            # the reference recomputes the trace each epoch (:474-500)
            timgs, tlabels = cnn.synthetic_image_batch(cfg, args.batch_size, rs)
            trace = None if rank else topk_grad.estimate_row_trace(
                loss_fn, state.params, (timgs, tlabels), n_samples=args.hessian_samples,
                key=topk_grad.prng_key(args.seed + epoch))
            trace = topk_grad.broadcast_trace(trace, state.params)
        imgs, labels = cnn.synthetic_image_batch(cfg, args.batch_size, rs)
        step = topk_grad.make_topk_dp_train_step(loss_fn, None, k, args.lr, args.wd, mode=args.mode,
                                                 trace=trace, device=dev, backend=backend)
        state, (loss, mb) = step(state, (imgs, labels))
        losses.append(loss)
        if i == 0:
            scores0 = state.scores.clone()
        synced.append(mb)
        if (i + 1) % args.print_freq == 0 and rank == 0:
            print(f"step {i+1}: loss {float(loss):.4f}, synced {float(mb):.3f} Melem/it, "
                  f"k={k}, {(time.perf_counter()-t0)/(i+1)*1e3:.2f} ms/it", flush=True)

    # the final eval on fresh synthetic batches (validate(), :586-629)
    eval_imgs, eval_labels = cnn.synthetic_image_batch(cfg, args.batch_size, rs)
    with torch.no_grad():
        logits = cnn.cnn_forward(cfg, state.params, torch.from_numpy(eval_imgs).to(dev))
        acc = float(cnn.accuracy_topk(logits, torch.from_numpy(eval_labels).to(dev), 1))
    if rank == 0:
        print(f"final: loss {float(loss):.4f}, top1 {acc*100:.2f}%", flush=True)
    return {"rc": 0, "state": state, "losses": torch.stack(losses) if losses else None,
            "synced": torch.stack(synced) if synced else None, "top1": acc,
            "scores0": scores0 if losses else None, "trace": trace}


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
