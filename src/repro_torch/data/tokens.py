"""Synthetic token pipeline for the LM architectures.

Counterpart of ``repro.data.tokens``. Deterministic, host-shardable and
restart-safe: the batch of step `step` for host `host` is a pure function
of (seed, step, host), so a pipeline restored from a checkpoint resumes
exactly, and a rescale only re-derives the host. Tokens follow the
reference's Zipf-ish marginal, p(r) proportional to 1 / (r + 10).

The bits are the port's own: each batch is drawn on the CPU by a
``torch.Generator`` seeded from (seed, step, host)
(``core.partition.seeded_generator``, the port's nested ``fold_in``) and
then moved to the pipeline's device, so a batch does not depend on the
device. ``jax.random.categorical``'s bits are not
reproduced (ROADMAP A8); tests that compare with the reference feed it
the reference's tokens.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.partition import seeded_generator
from repro_torch.platform import DeviceLike, resolve_device


def zipf_probabilities(vocab_size: int) -> torch.Tensor:
    """p(r) = (1 / (r + 10)) / sum_r' 1 / (r' + 10), float64 on the CPU: the
    reference's ``categorical`` over logits -log(r + 10)."""
    w = 1.0 / (torch.arange(vocab_size, dtype=torch.float64) + 10.0)
    return w / w.sum()


def synthetic_token_batch(seed: int, step: int, batch: int, seq_len: int,
                          vocab_size: int, host: int = 0,
                          num_hosts: int = 1, device: DeviceLike = None):
    """{'tokens': (batch, seq), 'targets': (batch, seq)} int64 on `device`
    (default: the CUDA device), the targets the tokens shifted by one.

    `batch` is the per-host batch; `num_hosts` is carried, as in the
    reference, and does not enter the draw."""
    dev = resolve_device(device)
    toks = torch.multinomial(zipf_probabilities(vocab_size),
                             batch * (seq_len + 1), replacement=True,
                             generator=seeded_generator("cpu", seed, step,
                                                        host))
    toks = toks.reshape(batch, seq_len + 1).to(dev)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclasses.dataclass
class TokenPipeline:
    """Stateful wrapper with a checkpointable cursor (the `step` counter)."""

    seed: int
    batch: int
    seq_len: int
    vocab_size: int
    host: int = 0
    num_hosts: int = 1
    step: int = 0
    device: DeviceLike = None

    def next(self):
        b = synthetic_token_batch(self.seed, self.step, self.batch,
                                  self.seq_len, self.vocab_size, self.host,
                                  self.num_hosts, self.device)
        self.step += 1
        return b

    # -- checkpoint integration -------------------------------------------
    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d):
        if int(d["seed"]) != self.seed:
            raise ValueError(f"pipeline seed mismatch on restore: the "
                             f"checkpoint has {d['seed']}, this pipeline "
                             f"{self.seed}")
        self.step = int(d["step"])

    def rescale(self, new_host: int, new_num_hosts: int) -> "TokenPipeline":
        """Elastic rescale: re-derive this host's stream; deterministic."""
        return dataclasses.replace(self, host=new_host,
                                   num_hosts=new_num_hosts)
