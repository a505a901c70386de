"""Scoring cells: a closed loop of one client handing host batches of uint8
images to the port's scores-only serving path, and fetching the [B] image
scores.

Per batch: `torch.from_numpy(batch).to(device)` (as `pipeline/eval._collect`
moves a batch), the payload function of `serving/aot.build_payload_fn_and_params`
(the evaluators' `make_nf_batch_fn` / `make_mdn_batch_fn`) under
`torch.inference_mode()`, the image-score tail `scoring.scores_tail`, and the
fetch of the scores to the host. The traffic file gives the batch, the pool
of distinct batches the window cycles through, and the share of defect
images."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import check, images, port, spec, weights
from harness.trace import WINDOW, Ranges, start_profiler
from reference.precision import set_f32_numerics
from reference.flow import Flow, anomaly_maps, tokens_to_map
from reference.mdn import MDN


class ScoreCell:
    def __init__(self, cell, seed: int, device: torch.device, program: bool = True) -> None:
        """The cell's inputs from `seed` and, with `program`, the port's
        scoring path on `device`."""
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        self.batch = int(tr["batch"])
        self.mean = np.asarray(cfg["mean"], np.float32)
        self.std = np.asarray(cfg["std"], np.float32)
        t0 = time.perf_counter()
        self.pool = images.make_pool(int(tr["pool_batches"]), self.batch, cfg["img_size"],
                                     float(tr["defect_share"]),
                                     weights.sub_seed(seed, "pool"), device)
        t_pool = time.perf_counter() - t0
        self.kept: Dict[int, torch.Tensor] = {}
        self.answers: List[tuple] = []
        self.latency: List[float] = []
        self.enqueue: List[float] = []
        self.phases = {"inputs": t_pool}
        if program:
            self._build()

    def _build(self) -> None:
        from vit_ad_tpu_torch.pipeline.loading import RunModels
        from vit_ad_tpu_torch.scoring import payload_ref_max_ll, scores_tail
        from vit_ad_tpu_torch.serving.aot import build_payload_fn_and_params

        cfg, seed, device = self.cell.config, self.seed, self.device
        hp = port.hyper_params(cfg)
        t0 = time.perf_counter()
        trunk_sd, head_sd = weights.make_states(cfg, seed, device)
        self.encoder = port.build_encoder(cfg, hp, trunk_sd, device)
        self.head = port.build_head(cfg, hp, self.encoder, head_sd, device).eval()
        del trunk_sd, head_sd
        self.phases["weights and models"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        models = RunModels(kind=cfg["head"], hp=hp, parts=(self.encoder, self.head))
        self.fn, _ = build_payload_fn_and_params(models, self.mean, self.std)
        self.ref_max = None
        if cfg["head"] == "mdn":  # the fixed normalizer, as `export_bundle` bakes it
            good = self.good_batch()
            with torch.inference_mode():
                payload = self.fn(torch.from_numpy(good).to(device)).float().cpu().numpy()
            self.ref_max = payload_ref_max_ll("mdn", payload)
        self.tail = scores_tail(cfg["head"], cfg["img_size"], self.ref_max)
        # the MDN's normalizer batch is its first call into the port
        self.phases["payload function and normalizer"] = time.perf_counter() - t0

    def good_batch(self) -> np.ndarray:
        return images.make_pool(1, self.batch, self.cell.config["img_size"], 0.0,
                                weights.sub_seed(self.seed, "good"), self.device)[0]

    def _one(self, k: int):
        t0 = time.perf_counter()
        with torch.inference_mode():
            x = torch.from_numpy(self.pool[k]).to(self.device)
            payload = self.fn(x)
            scores = self.tail(payload)
            t1 = time.perf_counter()
            host = scores.cpu().numpy()
        t2 = time.perf_counter()
        return payload, host, t1 - t0, t2 - t0

    def warm_up(self) -> None:
        t0 = time.perf_counter()
        for k in range(min(2, len(self.pool))):
            self._one(k)
        self.phases["warm-up"] = time.perf_counter() - t0

    def window(self, seconds: float, trace_seconds: float = 0.0):
        """Run the window. Returns (batches, window seconds, and for a
        traced run the (profiler, batches) of its traced part, else None)."""
        n = len(self.pool)
        traced = None
        i = 0
        t_start = time.perf_counter()
        untraced_until = seconds - trace_seconds if trace_seconds else seconds
        while True:
            k = i % n
            payload, host, enq, lat = self._one(k)
            if k not in self.kept:  # one payload a pool batch, for the reference
                self.kept[k] = payload
            self.answers.append((k, host))
            self.latency.append(lat)
            i += 1
            elapsed = time.perf_counter() - t_start
            if traced is None:
                self.enqueue.append(enq)
                if trace_seconds and elapsed >= untraced_until:
                    traced = self._traced(seconds - elapsed)
                    i += traced[1]
                    break
            if elapsed >= seconds:
                break
        t_end = time.perf_counter()
        return i, t_end - t_start, traced

    def _traced(self, seconds: float):
        """The traced part: ranges on, the profiler on, batches for
        `seconds` (at least one). Returns (profiler, batches)."""
        ranges = Ranges()
        ranges.module(self.encoder, "encoder")
        if self.cell.config["head"] == "nf":
            ranges.module(self.head, "flow")
        else:
            ranges.method(self.head, "log_likelihood", "mdn")
        prof = start_profiler()
        n, j = len(self.pool), 0
        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function(WINDOW):
            while True:
                k = (len(self.answers)) % n
                payload, host, _, lat = self._one(k)
                self.answers.append((k, host))
                self.latency.append(lat)
                j += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        prof.stop()
        ranges.remove()
        return prof, j

    def free(self) -> None:
        """Drop the program's state (the kept payloads stay)."""
        del self.encoder, self.head, self.fn, self.tail

    def reference(self) -> Dict[str, float]:
        """The reference over every pool batch; the gaps of every answer and
        of the kept payloads."""
        set_f32_numerics()
        cfg = self.cell.config
        trunk_sd, head_sd = weights.make_states(cfg, self.seed, self.device)
        trunk = spec.trunk(cfg).reference(trunk_sd, cfg, control=False)
        ref_scores, ref_payloads = self._reference_outputs(trunk, head_sd, control=False)
        score_gap = max(check.abs_gap(host, ref_scores[k]) for k, host in self.answers)
        kept = sorted(self.kept)
        prog = np.stack([self.kept[k].float().cpu().numpy() for k in kept])
        payload_gap = check.range_gap(prog, np.stack([ref_payloads[k] for k in kept]))
        return {"score_gap": score_gap, "payload_gap": payload_gap}

    @torch.no_grad()
    def _reference_outputs(self, trunk, head_sd, control: bool):
        """({pool index: reference scores}, {pool index: reference payload})
        of every pool batch, with the reference's own normalizer. `trunk` is
        the trunk family's plain reference."""
        cfg = self.cell.config
        img = cfg["img_size"]
        if cfg["head"] == "nf":
            flow = Flow(head_sd, cfg, control)

            def payload(feats):
                out = []
                for s in range(0, feats.shape[0], 32):
                    z, _ = flow.transform(tokens_to_map(feats[s:s + 32]))
                    out.append(anomaly_maps(z, img))
                return torch.cat(out)

            def scores(p):
                return p.reshape(p.shape[0], -1).amax(dim=1)
        else:
            mdn = MDN(head_sd, cfg, control)
            payload = mdn.token_scores
            good = torch.from_numpy(self.good_batch()).to(self.device)
            ref_max = float(payload(trunk.patch_features(good, self.mean, self.std)).max())

            def scores(p):
                prob = torch.exp(torch.clamp(p - ref_max, max=0.0))
                return 1.0 - prob.amin(dim=1)
        out_s, out_p = {}, {}
        for k, host in enumerate(self.pool):
            x = torch.from_numpy(host).to(self.device)
            p = payload(trunk.patch_features(x, self.mean, self.std))
            out_s[k] = scores(p).cpu().numpy()
            out_p[k] = p.cpu().numpy()
        return out_s, out_p

    def control(self) -> Dict[str, float]:
        """The control in the program's place: the reference one precision
        lower, judged by the same numbers against the reference."""
        set_f32_numerics()
        cfg = self.cell.config
        trunk_sd, head_sd = weights.make_states(cfg, self.seed, self.device)
        reference = spec.trunk(cfg).reference
        ref_s, ref_p = self._reference_outputs(reference(trunk_sd, cfg, control=False), head_sd,
                                               control=False)
        ctl_s, ctl_p = self._reference_outputs(reference(trunk_sd, cfg, control=True), head_sd,
                                               control=True)
        keys = sorted(ref_s)
        return {"score_gap": max(check.abs_gap(ctl_s[k], ref_s[k]) for k in keys),
                "payload_gap": check.range_gap(np.stack([ctl_p[k] for k in keys]),
                                               np.stack([ref_p[k] for k in keys]))}
