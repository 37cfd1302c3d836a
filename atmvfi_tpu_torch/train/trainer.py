"""Training engine: train and eval steps, AdamW, the epoch loop
(`atmvfi_tpu/train/trainer.py`).

One device (`TrainerConfig.device`, the card unless the caller asks for
the CPU), or a device mesh (`parallel.mesh.make_mesh`) whose 'data'
axis splits each batch, as the JAX trainer's `mesh` does; the forward
runs the network's kernels with gradients through their plain
versions' VJPs (`ops._autograd`). The optimizer is the JAX package's
optax chain, step for step:

* AdamW(0.9, 0.999, eps 1e-8, the phase's weight decay) with the
  cosine + warmup schedule evaluated at the update count before it
  increments (step 0's LR for the first update);
* the phase's frozen parameters (`phases.trainable_mask`) take no
  gradient, no update and no weight decay (optax `set_to_zero`);
  trainable parameters the forward did not reach get a zero gradient
  and so still decay, as under optax;
* an optional clip to a global norm over the trainable gradients
  (optax `clip_by_global_norm`: g / norm * max where norm >= max);
* gradient accumulation as `optax.MultiSteps`: the running (Welford)
  mean of k micro-step gradients, one update every k micro-steps, the
  schedule counting updates only.

Data parallelism, in one process: with d 'data' shards, shard i takes
rows [i B/d, (i + 1) B/d) of the batch (`NamedSharding(mesh,
P("data"))`'s placement) and runs on its own replica of the network,
replica 0 being `self.net` on the home device `mesh.devices[0][0]`. A
device may hold several shards, which then run in turn on it. Each
shard's forward and backward runs before the next shard's, with no host
sync between them. Every loss term is a mean over equal-sized samples,
so the global batch's loss and gradient (what JAX's step computes under
`jit` on the mesh) are the means of the shards': the shards' gradients
are summed on the home device and divided by d (the all-reduce), the
optimizer steps there once, and each replica copies the home weights.
The pose term is a mean over the batch's crops, not its samples, and
carries no gradient into the network (its crops are cut on the host):
it is computed once over the whole batch on the home device. A training
batch that d does not divide raises, as JAX's `device_put` does; an
evaluation batch that d does not divide runs on the home replica alone
(JAX raises there). A 'spatial' extent above 1 raises: the JAX trainer
replicates the batch over it, so those devices repeat their row's work.

The trainer touches no global setting (TF32, cuDNN benchmark): those
stay the caller's.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from atmvfi_tpu_torch import losses, ops
from atmvfi_tpu_torch.convert import save_npz
from atmvfi_tpu_torch.models import Network, get_config
from atmvfi_tpu_torch.parallel.mesh import DATA_AXIS, SPATIAL_AXIS
from atmvfi_tpu_torch.train.phases import PhaseConfig, trainable_mask
from atmvfi_tpu_torch.train.schedule import cosine_with_linear_warmup
from atmvfi_tpu_torch.utils.meters import AverageMeterGroups


def psnr_metric(pred, gt, max_val: float = 1.0):
    """Trainer PSNR: 10 log10(MAX / mse) per sample, then the mean (MAX,
    not MAX^2, as the reference trainer computes it)."""
    mse = torch.mean((pred - gt) ** 2, (1, 2, 3))
    return torch.mean(10.0 * torch.log10(max_val / mse))


def _max_pyr_levels(hw) -> int:
    """Levels for which reflect-pad-2 stays valid (dim // 2^k > 2)."""
    m = min(int(hw[0]), int(hw[1]))
    levels = 0
    while m > 4 and levels < 5:
        m //= 2
        levels += 1
    return max(levels, 1)


def make_criterion(phase: PhaseConfig,
                   perceptual_loss: Optional[Callable] = None,
                   pose_loss: Optional[Callable] = None):
    """The loss switchboard: (output, label) -> (loss, {name: term})."""

    def criterion(output, label):
        pred = output["I_t"]
        loss = 0.0
        ld: Dict[str, torch.Tensor] = {}
        if phase.use_l1_loss:
            ld["l1_loss"] = phase.l1_w * losses.charbonnier_loss(pred, label)
            loss = loss + ld["l1_loss"]
        if phase.use_lap_loss:
            ld["lap_loss"] = phase.lap_w * losses.lap_loss(pred, label, 5)
            loss = loss + ld["lap_loss"]
        if phase.use_warping_loss:
            # per-scale Laplacian with shrinking levels
            w = 0.0
            label_s = label
            im_t_list = output["im_t_list"]
            for scale, im_t in enumerate(im_t_list):
                max_levels = min(5 - (scale - 1), 5,
                                 _max_pyr_levels(im_t.shape[1:3]))
                w = w + losses.lap_loss(im_t, label_s, max_levels)
                if scale < len(im_t_list) - 1:
                    label_s = ops.downsample_2x(label_s)
            ld["warping_loss"] = phase.warping_w * w
            loss = loss + ld["warping_loss"]
        if (phase.use_perceptual_loss or phase.use_style_loss) \
                and perceptual_loss:
            p, s = perceptual_loss(pred, label)
            if phase.use_perceptual_loss:
                ld["perceptual_loss"] = phase.perceptual_w * p
                loss = loss + ld["perceptual_loss"]
            if phase.use_style_loss:
                ld["style_loss"] = phase.style_w * s
                loss = loss + ld["style_loss"]
        if phase.use_bidirect_warp_loss:
            b = 0.0
            for w0, w1 in zip(output["im0_warped_list"],
                              output["im1_warped_list"]):
                b = b + losses.census_loss(w0, w1)
            ld["bidirect_warp_loss"] = phase.bidirect_w * b
            loss = loss + ld["bidirect_warp_loss"]
        if phase.use_sobel_loss:
            ld["sobel_loss"] = phase.sobel_w * losses.sobel_loss(pred, label)
            loss = loss + ld["sobel_loss"]
        if phase.use_pose_loss and pose_loss is not None:
            ld["pose_loss"] = phase.pose_w * pose_loss(pred, label)
            loss = loss + ld["pose_loss"]
        return loss, ld

    return criterion


@dataclasses.dataclass
class TrainerConfig:
    phase: PhaseConfig
    variant: str = "base"
    dtype: torch.dtype = torch.float32  # working type of the towers
    steps_per_epoch: int = 1000  # len(train_loader); used for T_max
    num_epochs: Optional[int] = None  # default: phase.num_epochs
    resume: bool = False
    grad_accum: int = 1
    clip_grad_norm: Optional[float] = None
    checkpoint_dir: str = "checkpoints"
    seed: int = 0
    device: str = "cuda"  # without a mesh (a mesh names its own devices)


class Trainer:
    def __init__(self, config: TrainerConfig, mesh=None,
                 perceptual_loss: Optional[Callable] = None,
                 pose_loss: Optional[Callable] = None,
                 init_state_dict: Optional[Dict] = None):
        """`mesh` (a `parallel.mesh.DeviceMesh`) replaces `config.device`:
        the batch is split over its 'data' axis, and its first device is
        the home device."""
        self.c = config
        self.phase = config.phase
        self.mesh = mesh
        if mesh is None:
            devices = [torch.device(config.device)]
        elif mesh.shape[SPATIAL_AXIS] > 1:
            raise NotImplementedError(
                f"mesh {mesh.shape}: a 'spatial' axis above 1 is not "
                "ported to training (the JAX trainer replicates the batch "
                "over it, each device repeating its data row's work); use "
                "a (d, 1) mesh")
        else:
            devices = mesh.axis_devices(DATA_AXIS)
        if (any(d.type == "cuda" for d in devices)
                and not torch.cuda.is_available()):
            raise RuntimeError("no CUDA device: pass device='cpu' to train "
                               "on the CPU")
        self.device, self._devices = devices[0], devices
        self.cfg = get_config(config.variant, config.dtype)
        self.net = Network(self.cfg,
                           torch.Generator().manual_seed(config.seed))
        if init_state_dict is not None:
            self.net.load_state_dict(init_state_dict, strict=True)
        self.net.to(self.device)

        epochs = config.num_epochs or self.phase.num_epochs
        t_max = epochs * config.steps_per_epoch // max(config.grad_accum, 1)
        if len(self.phase.datasets) > 1:
            t_max //= 2  # alternating loaders
        warmup = (self.phase.warmup_steps_resume if config.resume
                  else self.phase.warmup_steps)
        self.schedule = cosine_with_linear_warmup(
            self.phase.init_lr, self.phase.last_lr, max(t_max, 1), warmup)
        self.num_epochs = epochs

        named = dict(self.net.named_parameters())
        self.mask = trainable_mask(named, self.phase.train_local,
                                   self.phase.train_global,
                                   self.phase.refiner_only)
        for name, p in named.items():
            p.requires_grad_(self.mask[name])
        self.trainable = [p for n, p in named.items() if self.mask[n]]
        # one replica a shard (the frozen flags copied with it), one
        # criterion a device (the VGG weights where the shard runs)
        self.replicas = [self.net] + [copy.deepcopy(self.net).to(d)
                                      for d in devices[1:]]
        self._trainables = [self.trainable] + [
            [p for n, p in r.named_parameters() if self.mask[n]]
            for r in self.replicas[1:]]
        criteria = {}
        for d in devices:
            if d not in criteria:
                perc = perceptual_loss
                if isinstance(perc, torch.nn.Module):
                    perc = (perc.to(d) if d == self.device
                            else copy.deepcopy(perc).to(d))
                criteria[d] = make_criterion(self.phase, perc)
        self._criteria = [criteria[d] for d in devices]
        self.pose_loss = pose_loss
        self.optimizer = self._make_optimizer()
        self.step = 0  # micro-steps taken (train steps)
        self.updates = 0  # optimizer updates made: the schedule's count
        self.micro_step = 0  # micro-steps into the accumulation window
        self._acc: List[torch.Tensor] = []

    # ------------------------------------------------------------------
    def _make_optimizer(self):
        """AdamW over the trainable parameters (the learning rate is set
        per update from the schedule)."""
        return torch.optim.AdamW(
            self.trainable, lr=self.schedule(0), betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.phase.weight_decay)

    def _as_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def apply_gradients(self) -> bool:
        """One micro-step on the trainable parameters' `.grad` (this
        micro-step's gradients, which it clears): accumulate, and at the
        k-th micro-step update. Returns whether it updated."""
        k = max(self.c.grad_accum, 1)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.trainable]
        with torch.no_grad():
            if self.micro_step == 0:
                self._acc = grads
            else:  # Welford: acc + (g - acc) / (n + 1)
                n = self.micro_step
                for a, g in zip(self._acc, grads):
                    a.add_((g - a) / (n + 1))
        self.optimizer.zero_grad(set_to_none=True)
        self.micro_step += 1
        self.step += 1
        if self.micro_step < k:
            return False
        acc, self._acc, self.micro_step = self._acc, [], 0
        with torch.no_grad():
            if self.c.clip_grad_norm:
                mx = self.c.clip_grad_norm
                norm = torch.sqrt(sum(torch.sum(g * g) for g in acc))
                acc = [torch.where(norm < mx, g, g / norm * mx) for g in acc]
        for p, g in zip(self.trainable, acc):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1
        return True

    def _run_shards(self, n: int, im0, gt, im1,
                    train: bool) -> Dict[str, torch.Tensor]:
        """The first n replicas' forwards (and backwards when training),
        each on its shard, rows [i B/n, (i + 1) B/n), one after another;
        the shards' metrics' means on the home device, the pose term over
        the whole batch."""
        rows = len(im0) // n
        shards = [[torch.as_tensor(x)[i * rows:(i + 1) * rows].to(dev)
                   for x in (im0, gt, im1)]
                  for i, dev in enumerate(self._devices[:n])]
        per, preds = [], []
        for net, crit, (a, g, b) in zip(self.replicas, self._criteria,
                                        shards):
            out = net(a, b, global_motion=self.phase.global_motion)
            loss, ld = crit(out, g)
            if train:
                loss.backward()
            with torch.no_grad():
                preds.append(out["I_t"].detach())
                per.append({"loss": torch.as_tensor(loss).detach(),
                            "psnr": psnr_metric(preds[-1], g),
                            **{k: torch.as_tensor(v).detach()
                               for k, v in ld.items()}})
            del out, loss, ld
        metrics = per[0] if n == 1 else {
            k: sum(m[k].to(self.device) for m in per) / n for k in per[0]}
        if self.phase.use_pose_loss and self.pose_loss is not None:
            with torch.no_grad():
                term = self.phase.pose_w * self.pose_loss(
                    torch.cat([p.to(self.device) for p in preds]),
                    torch.cat([s[1].to(self.device) for s in shards]))
            metrics["loss"] = metrics["loss"] + term
            metrics["pose_loss"] = term
        return metrics

    def _reduce_gradients(self) -> None:
        """The all-reduce: the mean of the shards' gradients into the
        home replica's `.grad`; the other replicas' cleared."""
        n = len(self.replicas)
        if n == 1:
            return
        with torch.no_grad():
            for home, *others in zip(*self._trainables):
                if home.grad is None:  # the forward did not reach it
                    continue
                for q in others:
                    home.grad.add_(q.grad.to(self.device))
                    q.grad = None
                home.grad.div_(n)

    def _broadcast(self) -> None:
        """Every replica takes the home replica's trainable weights."""
        with torch.no_grad():
            for params in self._trainables[1:]:
                for q, p in zip(params, self.trainable):
                    q.copy_(p)

    def train_step(self, im0, gt, im1) -> Dict[str, torch.Tensor]:
        """Forward, criterion and backward on each shard, the shards'
        mean gradient, an optimizer micro-step on the home device, the
        replicas updated. Returns the metrics as 0-d tensors on the home
        device (not synchronised)."""
        n = len(self.replicas)
        if len(im0) % n:
            raise ValueError(f"batch {len(im0)} must divide over the {n} "
                             "'data' shards")
        metrics = self._run_shards(n, im0, gt, im1, train=True)
        self._reduce_gradients()
        if self.apply_gradients():
            self._broadcast()
        return metrics

    @torch.no_grad()
    def eval_step(self, im0, gt, im1) -> Dict[str, torch.Tensor]:
        """Over the shards; a batch they do not divide (a validation
        loader's batch 1 or its last batch) runs on the home replica
        alone, where JAX's `device_put` raises: the metrics are
        per-sample means, so the numbers are the same."""
        n = len(self.replicas)
        return self._run_shards(n if len(im0) % n == 0 else 1, im0, gt, im1,
                                train=False)

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """Model, optimizer, schedule position and step, and the
        gradients accumulated so far in the current window."""
        return {"model": self.net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "updates": self.updates, "step": self.step,
                "micro_step": self.micro_step,
                "acc_grads": [a.detach().clone() for a in self._acc]}

    def load_state_dict(self, state: Dict) -> None:
        """Restore in place (`copy_`), the home replica, then the others
        from it."""
        self.net.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.updates, self.step = state["updates"], state["step"]
        self.micro_step = state["micro_step"]
        self._acc = [a.to(self.device) for a in state["acc_grads"]]
        for r in self.replicas[1:]:
            r.load_state_dict(self.net.state_dict(), strict=True)

    # ------------------------------------------------------------------
    def train_epoch(self, loader, max_iters: Optional[int] = None) -> Dict:
        meters = AverageMeterGroups()
        for i, (im0, gt, im1) in enumerate(loader):
            if max_iters is not None and i >= max_iters:
                break
            metrics = self.train_step(im0, gt, im1)
            meters.update({k: float(v) for k, v in metrics.items()})
        return {k: m.avg for k, m in meters.meter_dict.items()}

    def eval_epoch(self, loader, max_iters: Optional[int] = None) -> Dict:
        meters = AverageMeterGroups()
        for i, (im0, gt, im1) in enumerate(loader):
            if max_iters is not None and i >= max_iters:
                break
            metrics = self.eval_step(im0, gt, im1)
            meters.update({k: float(v) for k, v in metrics.items()})
        return {k: m.avg for k, m in meters.meter_dict.items()}

    @torch.no_grad()
    def visualize_batch(self, im0, gt, im1, out_dir: str, index: int) -> str:
        """Validation montage of the batch's first sample: inputs,
        prediction, ground truth, flows, occlusion."""
        from atmvfi_tpu_torch.utils.visualize import save_prediction

        out = self.net(self._as_device(im0), self._as_device(im1),
                       global_motion=self.phase.global_motion)
        pred = out["I_t"][:1]
        p = float(psnr_metric(pred, self._as_device(gt[:1])))

        def host(t):
            return t[0].float().cpu().numpy()

        return save_prediction(
            im0[0], im1[0], host(pred), gt[0], out_dir, index, psnr=p,
            flow0=host(out["opt_flow_0"]), flow1=host(out["opt_flow_1"]),
            occ=host(out["occ_mask1"]))

    @staticmethod
    def format_metric_deltas(current: Dict, previous: Optional[Dict]) -> str:
        """Per-metric values with +/- deltas against the previous epoch."""
        parts = []
        for k, v in current.items():
            if previous and k in previous:
                diff = v - previous[k]
                sign = "+" if diff > 0 else ""
                parts.append(f"{k}: {v:.5f}({sign}{diff:.5f})")
            else:
                parts.append(f"{k}: {v:.5f}")
        return "  ".join(parts)

    def fit(self, train_loaders: Sequence, val_loader,
            max_iters: Optional[int] = None, log_fn: Callable = print,
            checkpoint_prefix: str = "", viz_dir: Optional[str] = None,
            alternate_every: int = 1) -> List[Dict]:
        """Alternate the training sets every `alternate_every` epochs,
        validate, write each epoch's params `.npz` (the JAX package's
        format, with the metrics as meta)."""
        os.makedirs(self.c.checkpoint_dir, exist_ok=True)
        history = []
        prev_train, prev_val = None, None
        for epoch in range(self.num_epochs):
            loader = train_loaders[
                (epoch // max(alternate_every, 1)) % len(train_loaders)]
            t0 = time.time()
            train_m = self.train_epoch(loader, max_iters)
            val_m = self.eval_epoch(val_loader, max_iters)
            if viz_dir is not None:
                for im0, gt, im1 in val_loader:
                    self.visualize_batch(im0, gt, im1, viz_dir, epoch)
                    break
            dt = time.time() - t0
            history.append({"epoch": epoch, "train": train_m, "val": val_m,
                            "sec": dt})
            log_fn(f"[{self.phase.name}] epoch {epoch} ({dt:.1f}s)\n"
                   f"  train: {self.format_metric_deltas(train_m, prev_train)}"
                   f"\n  val:   {self.format_metric_deltas(val_m, prev_val)}")
            prev_train, prev_val = train_m, val_m
            psnr = val_m.get("psnr", 0.0)
            name = (f"{checkpoint_prefix}{self.phase.name}_epoch_{epoch}"
                    f"_psnr_{psnr:.4f}.npz")
            save_npz(os.path.join(self.c.checkpoint_dir, name),
                     self.net.state_dict(),
                     meta={"epoch": epoch, "phase": self.phase.name,
                           "train_metric": train_m, "val_metric": val_m})
        return history
