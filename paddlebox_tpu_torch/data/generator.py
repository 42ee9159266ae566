"""Synthetic CTR files in the MultiSlot text format.

Counterpart of paddlebox_tpu/data/generator.py: the same arguments write
byte-identical files. Each sparse slot draws feasigns from its own id range;
the click probability follows hidden per-feasign weights, so a model that
learns its embeddings beats AUC 0.5. ``dense_dim`` appends a dense float
slot of that many columns (drawn after the sparse slots, written "%.4f");
``conversion`` adds a ``label_cvr`` slot after the click: a post-click
conversion label with hidden weights of its own, drawn only for clicked
lines, which the feed config names as the "cvr" task's label.
``ins_id_vocab`` (the port's own option) leads each line with an instance
id ``item<k>``, k uniform below ``ins_id_vocab``, drawn from a generator of
its own, so the rest of each line is the line the same arguments write
without ids; the feed config then has ``parse_ins_id``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

import numpy as np

from paddlebox_tpu_torch.config.configs import DataFeedConfig, SlotConfig


def default_feed_config(num_slots: int = 8, batch_size: int = 256,
                        max_len: int = 4, dense_dim: int = 0,
                        conversion: bool = False) -> DataFeedConfig:
    slots: List[SlotConfig] = [SlotConfig("click", type="float",
                                          is_used=False)]
    if conversion:
        slots.append(SlotConfig("label_cvr", type="float", is_used=False))
    for i in range(num_slots):
        slots.append(SlotConfig(f"slot_{i}", type="uint64", max_len=max_len))
    if dense_dim:
        slots.append(SlotConfig("dense", type="float", dim=dense_dim))
    return DataFeedConfig(
        slots=tuple(slots), batch_size=batch_size,
        task_label_slots=(("cvr", "label_cvr"),) if conversion else ())


def write_synthetic_ctr_files(
        out_dir: str, num_files: int = 4, lines_per_file: int = 1024,
        num_slots: int = 8, vocab_per_slot: int = 1000, max_len: int = 4,
        dense_dim: int = 0, seed: int = 0,
        conversion: bool = False,
        ins_id_vocab: int = 0) -> Tuple[List[str], DataFeedConfig]:
    """Returns (file list, matching DataFeedConfig with batch_size 256)."""
    rng = np.random.RandomState(seed)
    id_rng = np.random.RandomState([seed, 1]) if ins_id_vocab else None
    os.makedirs(out_dir, exist_ok=True)
    hidden = [rng.randn(vocab_per_slot) * 0.7 for _ in range(num_slots)]
    hidden_cvr = [rng.randn(vocab_per_slot) * 0.7 for _ in range(num_slots)]
    files = []
    for fi in range(num_files):
        path = os.path.join(out_dir, f"part-{fi:05d}.txt")
        with open(path, "w") as f:
            for _ in range(lines_per_file):
                logit = -0.7
                logit_cvr = 0.3
                toks: List[str] = []
                if id_rng is not None:
                    toks.append("item%d" % id_rng.randint(ins_id_vocab))
                line_feas = []
                for si in range(num_slots):
                    n = rng.randint(1, max_len + 1)
                    feas = rng.randint(0, vocab_per_slot, n)
                    logit += hidden[si][feas].mean()
                    logit_cvr += hidden_cvr[si][feas].mean()
                    line_feas.append((n, feas + si * vocab_per_slot))
                p = 1.0 / (1.0 + np.exp(-logit))
                click = int(rng.rand() < p)
                toks.append(f"1 {click}")
                if conversion:
                    p_cvr = 1.0 / (1.0 + np.exp(-logit_cvr))
                    # the draw happens for clicked lines only
                    conv = int(click and rng.rand() < p_cvr)
                    toks.append(f"1 {conv}")
                for n, feas in line_feas:
                    toks.append(str(n) + " " + " ".join(str(x) for x in feas))
                if dense_dim:
                    dvals = rng.randn(dense_dim) * 2.0 + 1.0
                    toks.append(str(dense_dim) + " "
                                + " ".join(f"{v:.4f}" for v in dvals))
                f.write(" ".join(toks) + "\n")
        files.append(path)
    feed = default_feed_config(num_slots, max_len=max_len,
                               dense_dim=dense_dim, conversion=conversion)
    return files, dataclasses.replace(feed, parse_ins_id=bool(ins_id_vocab))
