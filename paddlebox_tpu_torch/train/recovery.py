"""Recovery loop: the pass boundary is the checkpoint and the fault check.

Counterpart of paddlebox_tpu/train/recovery.py. Each completed pass writes
``<batch_model_dir>/<day>/pass-<i>/`` with a DONE marker (a crash during a
save leaves no DONE, and that pass trains again), in save_base mode
'auto': with the touched-row journal on (CkptFlags.ckpt_journal, the
default) the first save is full and every later one a journal-mode
snapshot, {hard links to the base's parts + the journal's segments since},
whose cost follows the rows the passes touched. Snapshots are
self-contained (links), so pruning to ``keep_last`` passes stays safe. A
restarted job makes a fresh trainer and runner over the same directories;
``run`` resumes after the newest completed pass, and the checkpoint
carries the trainer's random streams (BoxTrainer.random_state), and in
async mode the host dense table's state (``async_dense_state``, reference
recovery.py:87-96, 140-143), so the resumed run is bit-identical to one
that never stopped (in async mode, where the table's bursts repeat: each
push drained before the next).

``elastic`` is any object with ``check()``, called at every pass boundary
(the reference's fleet.elastic.ElasticManager raises DeadRankError there);
the port has no elastic manager of its own yet.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Dict, List

from paddlebox_tpu_torch.train.checkpoint import CheckpointManager


class RecoverableRunner:
    def __init__(self, trainer, ckpt: CheckpointManager, day: str,
                 elastic=None, keep_last: int = 2) -> None:
        """trainer: a BoxTrainer whose table ``ckpt`` checkpoints;
        keep_last: completed per-pass checkpoints kept (older ones are
        pruned)."""
        self.trainer = trainer
        self.ckpt = ckpt
        self.day = day
        self.elastic = elastic
        self.keep_last = max(1, keep_last)

    # ------------------------------------------------------------ resume
    def _pass_dir_root(self) -> str:
        return os.path.join(self.ckpt.cfg.batch_model_dir, self.day)

    def completed_passes(self) -> int:
        """Highest i with a DONE marker in <day>/pass-<i>, plus one; 0 when
        there is none."""
        root = self._pass_dir_root()
        if not os.path.isdir(root):
            return 0
        best = -1
        for name in os.listdir(root):
            m = re.fullmatch(r"pass-(\d+)", name)
            if m and os.path.exists(os.path.join(root, name, "DONE")):
                best = max(best, int(m.group(1)))
        return best + 1

    def resume(self) -> int:
        """Restore the trainer from the newest completed pass: the store
        (with the save's stat rewrite replayed), the dense parameters and
        Adam state, and the random streams.
        Returns the passes already done (0: a fresh start). A checkpoint
        whose dense state names other parameters or Adam fields than this
        trainer's raises ValueError (its store is loaded by then)."""
        done = self.completed_passes()
        if done == 0:
            return 0
        params, opt_state, extra = self.ckpt.load_base(
            os.path.join(self.day, f"pass-{done - 1}"))
        want = _dense_structure(self.trainer.params, self.trainer.opt_state)
        got = _dense_structure(params, opt_state)
        if want != got:
            raise ValueError(
                "restored dense state does not match this trainer's model "
                "and optimizer:\n  checkpoint: %s\n  trainer:    %s"
                % (got, want))
        # the saver rewrote its store's stat columns after the snapshot; the
        # reference's resume skips this, and its delta scores and unseen
        # days then differ from a run that never stopped
        self.ckpt.replay_base_rewrite()
        self.trainer.restore_dense(params, opt_state)
        if getattr(self.trainer, "async_table", None) is not None:
            # async mode reads its dense state from the host table, not
            # from params: a resume that skipped it would diverge
            state = extra.get("async_dense_state")
            if state is None:
                raise ValueError("checkpoint has no async dense state but "
                                 "the trainer runs in async mode")
            self.trainer.load_async_state(state)
        self.trainer.set_random_state(extra)
        return done

    # --------------------------------------------------------------- run
    def _prune(self, done: int) -> None:
        for base in (self.ckpt.cfg.batch_model_dir,
                     self.ckpt.cfg.xbox_model_dir):
            root = os.path.join(base, self.day)
            for i in range(done - self.keep_last):
                d = os.path.join(root, f"pass-{i}")
                if os.path.isdir(d):
                    shutil.rmtree(d, ignore_errors=True)

    def run(self, datasets, resume: bool = True) -> List[Dict[str, float]]:
        """Train the datasets, one pass each, saving after every pass and
        checking ``elastic`` before it; with ``resume``, the passes a
        completed checkpoint covers are skipped. Returns the stats of the
        passes trained here. An error of ``elastic.check`` propagates: the
        scheduler restarts the job, and this method resumes."""
        done = self.resume() if resume else 0
        stats: List[Dict[str, float]] = []
        for i, ds in enumerate(datasets):
            if i < done:
                continue
            if self.elastic is not None:
                self.elastic.check()
            stats.append(self.trainer.train_pass(ds))
            extra = {"completed_passes": i + 1,
                     **self.trainer.random_state()}
            table = getattr(self.trainer, "async_table", None)
            if table is not None:
                table.wait_drained()
                extra["async_dense_state"] = table.state()
            self.ckpt.save_base(self.trainer.params, self.trainer.opt_state,
                                day=os.path.join(self.day, f"pass-{i}"),
                                extra=extra, mode="auto")
            self.ckpt.wait()
            self._prune(i + 1)
        return stats


def _dense_structure(params, opt_state):
    """The names a dense state holds: parameter names, and the Adam state's
    fields with the parameter names under each moment."""
    return (sorted(params),
            sorted((k, tuple(sorted(v)) if isinstance(v, dict) else None)
                   for k, v in opt_state.items()))
