"""swservice: batched SW scoring over a list of devices.

Port of kit4b_tpu/parallel/swservice.py. The reference sends SW jobs to
remote provider machines over its own framed TCP protocol (pacbiokit4b
BKScommon.h, BKSRequester.cpp, BKSProvider.cpp); here the jobs are packed
into fixed-shape batches, split over a "dp" axis of devices, and each
device runs the banded SW scan (`kernels.sw.sw_scan` without traceback) on
its shard. `align` runs `pacbio.sswd.banded_sw_batch` with traceback on the
first device, as JAX's does. Several processes compose with
`parallel/distributed.py` (each feeds its own share of the jobs).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..kernels.sw import sw_scan
from ..pacbio.sswd import SWScores, banded_sw_batch
from .mesh import Mesh, all_gather, default_devices


@dataclass
class SWJob:
    probe: np.ndarray
    target: np.ndarray
    diag0: int = 0


def _pack(jobs: list, B: int, Lp: int, Lt: int):
    """Jobs -> (probes [B, Lp], targets [B, Lt] padded with 0x0F, plens,
    tlens, diag0 [B] int32); rows past the jobs are empty pairs."""
    probes = np.full((B, Lp), 0x0F, np.uint8)
    targets = np.full((B, Lt), 0x0F, np.uint8)
    plens = np.zeros(B, np.int32)
    tlens = np.zeros(B, np.int32)
    diag0 = np.zeros(B, np.int32)
    for i, j in enumerate(jobs):
        probes[i, :len(j.probe)] = j.probe
        targets[i, :len(j.target)] = j.target
        plens[i] = len(j.probe)
        tlens[i] = len(j.target)
        diag0[i] = j.diag0
    return probes, targets, plens, tlens, diag0


@dataclass
class SWService:
    """Batch SW scorer over `devices` (default: every visible CUDA device;
    `[torch.device("cuda", 0)] * D` runs D shards on one card).

    >>> svc = SWService(band=256)
    >>> scores = svc.score([SWJob(p, t), ...])   # one scan a shard
    """
    band: int = 256
    scores: SWScores = field(default_factory=SWScores)
    devices: list | None = None

    def __post_init__(self):
        devs = list(self.devices) if self.devices is not None \
            else default_devices()
        self.mesh = Mesh(devs, ("dp",))
        self.n_dev = len(devs)

    def score(self, jobs: list[SWJob]) -> np.ndarray:
        """Peak SW score per job ([len(jobs)] int32): the jobs are padded
        to a whole number of shards, both lengths to multiples of 512, and
        shard d runs on device d."""
        if not jobs:
            return np.zeros(0, np.int32)
        D = self.n_dev
        B = -(-len(jobs) // D) * D
        Lp = -(-max(len(j.probe) for j in jobs) // 512) * 512
        Lt = -(-max(len(j.target) for j in jobs) // 512) * 512
        arrays = _pack(jobs, B, Lp, Lt)
        sc = self.scores
        per = B // D
        devices = list(self.mesh.devices.flat)
        best = []
        for d, dev in enumerate(devices):
            shard = (torch.from_numpy(a[d * per:(d + 1) * per]).to(dev)
                     for a in arrays)
            b, _, _, _ = sw_scan(*shard, W=self.band, match=sc.match,
                                 mismatch=sc.mismatch,
                                 gap_open=sc.gap_open, gap_ext=sc.gap_ext,
                                 traceback=False)
            best.append(b)
        return all_gather(best, devices[0]).cpu().numpy()[:len(jobs)]

    def align(self, jobs: list[SWJob]):
        """Full alignments (with traceback) on the first device."""
        if not jobs:
            return []
        B = len(jobs)
        Lp = max(len(j.probe) for j in jobs)
        Lt = max(len(j.target) for j in jobs)
        probes, targets, plens, tlens, diag0 = _pack(jobs, B, Lp, Lt)
        return banded_sw_batch(probes, plens, targets, tlens, diag0,
                               band=self.band, scores=self.scores,
                               device=self.mesh.devices.flat[0])
