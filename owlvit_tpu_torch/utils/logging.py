"""Metrics logging: loss accumulation, epoch table, JSONL stream.

Covers the reference's GeneralLossAccumulator + ProgressFormatter
(src/util.py:14-78) with the accumulator's reset bug fixed
(util.py:30-31 resets the wrong attribute, silently turning per-epoch means
into all-run means) and adds a machine-readable JSONL metrics stream — the
observability the reference's dead TensorBoard import never delivered
(util.py:7; SURVEY §5.5-5.6).

The port's copy of owlvit_tpu/utils/logging.py; tests/test_torch_run.py
holds it equal.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from datetime import timedelta


class LossAccumulator:
    def __init__(self):
        self.reset()

    def update(self, losses: dict) -> None:
        for k, v in losses.items():
            self._sums[k] += float(v)
        self._n += 1

    def update_sums(self, sums: dict, n: int) -> None:
        """Add n steps at once from their terms' sums (float64, added in
        step order): the same means as n calls of update."""
        for k, v in sums.items():
            self._sums[k] += float(v)
        self._n += n

    def means(self) -> dict:
        if self._n == 0:
            return {}
        return {k: round(v / self._n, 5) for k, v in self._sums.items()}

    def reset(self) -> None:
        self._sums = defaultdict(float)
        self._n = 0


class ProgressFormatter:
    """Per-epoch console table: losses, mAP, mAP@50, size-bucketed AP/AR."""

    COLUMNS = (
        "epoch", "class loss", "bg loss", "box loss", "map", "map@0.5",
        "map (L/M/S)", "mar (L/M/S)", "time elapsed",
    )

    def __init__(self):
        self.rows = []
        self.start = time.time()

    def update(self, epoch: int, train_metrics: dict, val_metrics: dict) -> None:
        # val_metrics may be {} on epochs where eval was skipped
        # (training.eval_every_epochs > 1): show "-" in the mAP columns.
        def lms(prefix):
            if not val_metrics:
                return "-"
            return "/".join(
                str(round(float(val_metrics[f"{prefix}_{s}"]), 2))
                for s in ("large", "medium", "small")
            )

        def val(key):
            return round(float(val_metrics[key]), 3) if val_metrics else "-"

        self.rows.append(
            (
                epoch,
                train_metrics.get("loss_ce", float("nan")),
                train_metrics.get("loss_bg", float("nan")),
                round(
                    train_metrics.get("loss_bbox", 0.0)
                    + train_metrics.get("loss_giou", 0.0),
                    5,
                ),
                val("map"),
                val("map_50"),
                lms("map"),
                lms("mar"),
                str(timedelta(seconds=int(time.time() - self.start))),
            )
        )

    def render(self) -> str:
        try:
            from tabulate import tabulate

            return tabulate(self.rows, headers=self.COLUMNS)
        except ImportError:  # pragma: no cover
            lines = ["\t".join(self.COLUMNS)]
            lines += ["\t".join(str(c) for c in r) for r in self.rows]
            return "\n".join(lines)

    def print(self) -> None:
        print("\n" + self.render() + "\n", flush=True)


class JSONLLogger:
    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def log(self, record: dict) -> None:
        record = dict(record, time=time.time())
        self._fh.write(json.dumps(record, default=_jsonable) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def _jsonable(x):
    try:
        import numpy as np

        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, (np.floating, np.integer)):
            return x.item()
    except ImportError:
        pass
    return str(x)
