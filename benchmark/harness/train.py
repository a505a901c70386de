"""Training cells: head steps on cached trunk features, as the port's
frozen-trunk trainers take them (`pipeline/train._train_head`).

Set-up extracts the features of the traffic's good images through
`pipeline.features.make_feature_extractor` and `extract_features`, stages
them with `stage_feature_batches`, builds the head and `torch_adam` at the
configuration's settings, and drives that one trainer through its first
steps with `pipeline.train.train_step` (the check's steps: their losses,
the first gradient as Adam's state holds it, and each parameter's change);
the window then goes on with the same objects. Each epoch of staged batches
ends with the fetch of its losses, as `train_epoch` does; validation passes
and early-stopping snapshots are left out."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import check, images, port, spec, weights
from harness.trace import WINDOW, Ranges, start_profiler
from reference.precision import set_f32_numerics
from reference.train import FAULTS, head_steps


class TrainCell:
    def __init__(self, cell, seed: int, device: torch.device, program: bool = True) -> None:
        """The cell's inputs from `seed` and, with `program`, the port's
        trainer on `device`, driven through the check's steps."""
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.batch = int(tr["batch"])
        self.check_steps = int(tr["check_steps"])
        self.mean = np.asarray(cfg["mean"], np.float32)
        self.std = np.asarray(cfg["std"], np.float32)
        t0 = time.perf_counter()
        self.images = self.train_images()
        self.phases = {"inputs": time.perf_counter() - t0}
        self.enqueue: List[float] = []
        if program:
            self._build()

    def _build(self) -> None:
        from vit_ad_tpu_torch.data.loader import Batch
        from vit_ad_tpu_torch.pipeline import train as T
        from vit_ad_tpu_torch.pipeline.features import (
            extract_features,
            make_feature_extractor,
            stage_feature_batches,
        )
        from vit_ad_tpu_torch.pipeline.optimizers import torch_adam

        cfg, tr, device = self.cell.config, self.cell.traffic, self.device
        hp = port.hyper_params(cfg)
        t0 = time.perf_counter()
        trunk_sd, head_sd = weights.make_states(cfg, self.seed, device)
        self.encoder = port.build_encoder(cfg, hp, trunk_sd, device)
        del trunk_sd
        self.phases["weights and trunk"] = time.perf_counter() - t0
        extractor = make_feature_extractor(self.encoder, hp.block_index, self.mean, self.std)
        eb = int(tr["extract_batch"])
        batches = (Batch(images=self.images[s:s + eb], valid=np.ones(eb, bool))
                   for s in range(0, len(self.images), eb))
        feats = extract_features(extractor, batches, device)
        self.staged = list(stage_feature_batches(feats, self.batch)())
        del feats
        self.phases["feature cache"] = time.perf_counter() - t0 - self.phases["weights and trunk"]
        self.head = port.build_head(cfg, hp, self.encoder, head_sd, device).train()
        self.loss_fn = T.masked_mdn_loss if cfg["head"] == "mdn" else T.masked_nf_loss
        self.train_step = T.train_step
        train = cfg["train"]
        self.opt = torch_adam(self.head.parameters(), train["learning_rate"],
                              train["weight_decay"])
        self.noise = (torch.Generator(device=device).manual_seed(self.noise_seed())
                      if tr["noise"] else None)
        self.step = 0
        t0 = time.perf_counter()
        self.prog = self._check_steps(head_sd)
        del head_sd
        self.phases["head, optimizer and the check's steps"] = time.perf_counter() - t0

    def train_images(self) -> np.ndarray:
        tr = self.cell.traffic
        n = int(tr["train_images"])
        return images.make_pool(1, n, self.cell.config["img_size"], 0.0,
                                weights.sub_seed(self.seed, "train"), self.device)[0]

    def noise_seed(self) -> int:
        return weights.sub_seed(self.seed, "noise")

    def _step(self) -> torch.Tensor:
        feats, valid, _ = self.staged[self.step % len(self.staged)]
        self.step += 1
        return self.train_step(self.loss_fn, self.head, self.opt, feats, valid, self.noise)

    def _check_steps(self, start: Dict[str, torch.Tensor]) -> dict:
        """The first steps, through the window's own call, and what the
        check compares of them."""
        losses, grads = [], None
        beta1 = self.opt.param_groups[0]["betas"][0]
        for s in range(self.check_steps):
            losses.append(self._step())
            if s == 0:  # the gradient Adam took: exp_avg = (1 - beta1) * g after one step
                grads = {k: (float(self.opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                             if p in self.opt.state else 0.0)  # no state: no step taken
                         for k, p in self._leaves(start)}
        with torch.no_grad():
            change = {k: float((p - start[k]).norm()) for k, p in self._leaves(start)}
        return {"losses": [float(v) for v in losses], "grad_norms": grads,
                "change_norms": change}

    def _leaves(self, start: Dict[str, torch.Tensor]):
        """(state-dict key, parameter) of the head's parameters that the
        state dict holds (not the flow's unused `layer_norm` member)."""
        return [(port.leaf_key(n), p) for n, p in self.head.named_parameters()
                if port.leaf_key(n) in start]

    def warm_up(self) -> None:
        """The check's steps ran every shape of the window already."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, trace_seconds: float = 0.0):
        """Run the window. Returns (steps, window seconds, and for a traced
        run the (profiler, steps) of its traced part, else None)."""
        n = len(self.staged)
        epoch: List[torch.Tensor] = []
        traced = None
        steps = 0
        t_start = time.perf_counter()
        untraced_until = seconds - trace_seconds if trace_seconds else seconds
        while True:
            t0 = time.perf_counter()
            epoch.append(self._step())
            self.enqueue.append(time.perf_counter() - t0)
            steps += 1
            if self.step % n == 0:
                self._end_epoch(epoch)
                epoch = []
            elapsed = time.perf_counter() - t_start
            if trace_seconds and elapsed >= untraced_until:
                self._end_epoch(epoch)
                epoch = []
                traced = self._traced(seconds - elapsed)
                steps += traced[1]
                break
            if elapsed >= seconds:
                break
        self._end_epoch(epoch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return steps, time.perf_counter() - t_start, traced

    def _end_epoch(self, losses: List[torch.Tensor]) -> None:
        if losses:
            vals = torch.stack(losses).cpu().numpy()
            if not np.all(np.isfinite(vals)):
                raise FloatingPointError(f"a training loss is not finite: {vals}")

    def _traced(self, seconds: float):
        ranges = Ranges()
        ranges.optimizer(self.opt)
        n, j = len(self.staged), 0
        epoch: List[torch.Tensor] = []
        prof = start_profiler()
        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function(WINDOW):
            while True:
                epoch.append(self._step())
                j += 1
                if self.step % n == 0:
                    self._end_epoch(epoch)
                    epoch = []
                if time.perf_counter() - t0 >= seconds:
                    break
            self._end_epoch(epoch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        prof.stop()
        ranges.remove()
        return prof, j

    def free(self) -> None:
        del self.encoder, self.head, self.opt, self.staged, self.noise

    def _reference_batches(self, trunk) -> List[torch.Tensor]:
        """The check's batches through the trunk family's plain reference."""
        x = torch.from_numpy(self.images).to(self.device)
        feats = trunk.patch_features(x, self.mean, self.std)
        return [feats[s * self.batch:(s + 1) * self.batch] for s in range(self.check_steps)]

    def _reference(self, control: bool = False, fault: Optional[str] = None) -> dict:
        set_f32_numerics()
        cfg, tr = self.cell.config, self.cell.traffic
        trunk_sd, head_sd = weights.make_states(cfg, self.seed, self.device)
        batches = self._reference_batches(spec.trunk(cfg).reference(trunk_sd, cfg, control))
        del trunk_sd
        return head_steps(cfg["head"], cfg, head_sd, batches, cfg["train"]["learning_rate"],
                          cfg["train"]["weight_decay"],
                          self.noise_seed() if tr["noise"] else None, control=control,
                          fault=fault)

    @staticmethod
    def gaps(got: dict, ref: dict) -> Dict[str, float]:
        skip = check.rounding_leaves(ref["raw_grad_norms"])
        return {"loss_gap": check.loss_gap(got["losses"], ref["losses"]),
                "grad_gap": check.leaf_gap(got["grad_norms"], ref["grad_norms"], skip),
                "change_gap": check.leaf_gap(got["change_norms"], ref["change_norms"], skip)}

    @staticmethod
    def details(got: dict, ref: dict) -> dict:
        """The gaps step by step and leaf by leaf, for the log."""
        skip = check.rounding_leaves(ref["raw_grad_norms"])
        return {"step_loss_gaps": [abs(p - r) / abs(r) for p, r in zip(got["losses"],
                                                                       ref["losses"])],
                "losses": got["losses"], "ref_losses": ref["losses"], "rounding_leaves": skip,
                "grad_leaf_gaps": check.leaf_gaps(got["grad_norms"], ref["grad_norms"], skip),
                "change_leaf_gaps": check.leaf_gaps(got["change_norms"], ref["change_norms"],
                                                    skip)}

    def reference(self) -> Dict[str, float]:
        ref = self._reference()
        self.last_details = self.details(self.prog, ref)
        return self.gaps(self.prog, ref)

    def control(self) -> Dict[str, Dict[str, float]]:
        """The control (one precision lower) and each planted fault that
        the head can have (`reference.train.FAULTS`), each in the program's
        place against the reference."""
        ref = self._reference()
        ctl = self._reference(control=True)
        out = {"control": self.gaps(ctl, ref), "control_details": self.details(ctl, ref)}
        for fault in FAULTS[self.cell.config["head"]]:
            if fault == "gumbel_off" and not self.cell.traffic["noise"]:
                continue
            got = self._reference(fault=fault)
            out[fault] = self.gaps(got, ref)
            out[f"{fault}_details"] = self.details(got, ref)
        return out
