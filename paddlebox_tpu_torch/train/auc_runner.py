"""The AUC runner: each slot's importance from test passes with that slot
shuffled.

Counterpart of paddlebox_tpu/train/auc_runner.py (BoxWrapper's aucrunner,
box_wrapper.h:895-998, behind FLAGS_padbox_auc_runner_mode, and
BoxHelper::SlotsShuffle, box_wrapper.h:1174-1198): after a pass trains,
the same records are replayed as test passes (BoxTrainer.predict_batches:
no feature created, nothing written back), once as they are and once a
probed slot with that slot's feasign lists permuted across the instances
(BoxDataset.slots_shuffle, RandomState(seed + slot)); the AUC lost is the
slot's signal. The dataset must be on the record path, and its records are
restored after each probe.

``maybe_run_auc_runner`` runs it only under HostFlags' ``auc_runner_mode``
(PBTPU_AUC_RUNNER_MODE).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from paddlebox_tpu_torch.config.flags import HostFlags
from paddlebox_tpu_torch.metrics.auc import BasicAucCalculator


def _eval_auc(trainer, dataset, table_size: int = 1 << 14) -> float:
    preds, labels = trainer.predict_batches(dataset)
    calc = BasicAucCalculator(table_size)
    calc.add_data(preds, labels)
    calc.compute()
    return calc.auc()


class AucRunner:
    """Slot-shuffle replays over a trained BoxTrainer."""

    def __init__(self, trainer, seed: int = 0) -> None:
        self.trainer = trainer
        self.seed = seed

    def run(self, dataset, slots: Optional[Sequence[int]] = None,
            table_size: int = 1 << 14) -> Dict[str, float]:
        """{"base_auc": a, "slot_<i>": a - auc with slot i shuffled, ...}
        for each used sparse slot ordinal in ``slots`` (all by default);
        loads ``dataset`` first if it is empty."""
        if len(dataset) == 0:
            dataset.load_into_memory()
        if slots is None:
            slots = range(len(dataset.feed.used_sparse_slots()))
        base = _eval_auc(self.trainer, dataset, table_size)
        out: Dict[str, float] = {"base_auc": base}
        for si in slots:
            saved = [r.uint64_slots.get(si) for r in dataset.records]
            dataset.slots_shuffle([si], seed=self.seed + si)
            auc = _eval_auc(self.trainer, dataset, table_size)
            for r, v in zip(dataset.records, saved):
                if v is None:
                    r.uint64_slots.pop(si, None)
                else:
                    r.uint64_slots[si] = v
            out["slot_%d" % si] = base - auc
        return out


def maybe_run_auc_runner(trainer, dataset,
                         slots: Optional[Sequence[int]] = None,
                         seed: int = 0,
                         flags: Optional[HostFlags] = None
                         ) -> Optional[Dict[str, float]]:
    """AucRunner(trainer, seed).run(dataset, slots) under ``flags``'
    (HostFlags(), the environment's) auc_runner_mode, else None."""
    if not (flags or HostFlags()).auc_runner_mode:
        return None
    return AucRunner(trainer, seed=seed).run(dataset, slots)
