"""Counterpart of unet_tpu/train/monitor.py (the port keeps its own copy).

Training observability: history JSON, loss-spike alarms, worst-sample
tracking (reference tools/train_with_monitoring.py:34-117)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple


class TrainingMonitor:
    """Loss/mIoU/lr/grad-norm history + spike alarm
    (reference TrainingMonitor, train_with_monitoring.py:34-93)."""

    def __init__(self, out_dir: str, spike_factor: float = 1.5):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.spike_factor = spike_factor
        self.history: Dict[str, List[float]] = {
            "loss": [], "miou": [], "lr": [], "grad_norm": []}
        self.alarms: List[str] = []

    def log_epoch(self, epoch: int, loss: float, miou: float, lr: float,
                  grad_norm: float) -> None:
        if self.history["loss"] and loss > self.spike_factor * self.history["loss"][-1]:
            msg = (f"epoch {epoch}: loss spike {self.history['loss'][-1]:.4f} "
                   f"-> {loss:.4f} (x{loss / max(self.history['loss'][-1], 1e-9):.2f})")
            self.alarms.append(msg)
            print(f"[monitor] ALARM {msg}")
        for k, v in (("loss", loss), ("miou", miou), ("lr", lr),
                     ("grad_norm", grad_norm)):
            self.history[k].append(float(v))
        (self.out_dir / "training_history.json").write_text(
            json.dumps({"history": self.history, "alarms": self.alarms}, indent=2))


class SampleLossTracker:
    """Top-K worst samples per epoch (reference SampleLossTracker,
    train_with_monitoring.py:96-117)."""

    def __init__(self, k: int = 10):
        self.k = k
        self.samples: List[Tuple[float, str]] = []

    def record(self, loss: float, sample_id: str) -> None:
        self.samples.append((float(loss), sample_id))

    def worst(self) -> List[Tuple[float, str]]:
        return sorted(self.samples, reverse=True)[:self.k]

    def reset(self) -> None:
        self.samples = []


class EarlyStopping:
    """Patience-based early stop (reference train_3class_advanced.py:83-103)."""

    def __init__(self, patience: int = 30, min_delta: float = 0.001):
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.counter = 0
        self.early_stop = False

    def step(self, score: float) -> bool:
        if self.best is None or score > self.best + self.min_delta:
            self.best = score
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop
