"""Event emitters: per-event files + optional MQTT, JSONL window log, CSV logs
(counterpart of unet_tpu/events/emitters.py).

Schema-compatible with the reference (the JSONL/JSON/CSV payloads are the
cross-system contract, SURVEY §5 'Metrics / logging'):
  * EventManager          — raw/overlay JPG + JSON payload + MQTT publish
                            (reference src/events/event_manager.py:15-62)
  * InspectionEventLogger — OK/NG-bucketed image dirs + JSONL + summary
                            (reference src/events/event_output.py:42-245)
  * AnomalyLogger / JSONLogger / StatisticsLogger
                            (reference src/utils/logger.py:13-194)
Images are written with OpenCV and MQTT goes through paho-mqtt, each
imported where it is used; without paho-mqtt, MQTT stays off.
"""
from __future__ import annotations

import csv
import datetime
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

CLASS_NAMES = {0: "background", 1: "cable", 2: "tape", 3: "bulge_defect",
               4: "loose_defect", 5: "damage_defect", 6: "thin_defect"}


def _imwrite(path, img_bgr, quality: int = 95) -> None:
    import cv2
    ok = cv2.imwrite(str(path), img_bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:  # CJK/odd-path fallback (reference infer_video.py:585-604)
        ext = os.path.splitext(str(path))[1] or ".jpg"
        ok2, buf = cv2.imencode(ext, img_bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if ok2:
            Path(path).write_bytes(buf.tobytes())


class EventManager:
    """Per-event image+JSON emitter with optional MQTT publish
    (reference event_manager.py:15-62)."""

    def __init__(self, out_dir: str, mqtt_cfg: Optional[Dict[str, Any]] = None):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        mqtt_cfg = mqtt_cfg or {}
        self.mqtt_topic = mqtt_cfg.get("topic", "cable/inspection/event")
        self.client = None
        mqtt = None
        if mqtt_cfg.get("enabled", False):
            try:  # optional, like the reference (event_manager.py:9-13)
                import paho.mqtt.client as mqtt
            except ImportError:
                print("note: paho-mqtt is not installed; MQTT publishing is off")
        self.mqtt_enabled = mqtt is not None
        if self.mqtt_enabled:
            self.client = mqtt.Client()
            self.client.connect(mqtt_cfg["host"], int(mqtt_cfg["port"]), keepalive=30)

    def emit(self, camera_id: str, frame_bgr, overlay_bgr, findings: List[dict],
             metrics: dict, timestamp_ns: int) -> Dict[str, Any]:
        ts = time.strftime("%Y%m%d_%H%M%S", time.localtime())
        base = f"{ts}_{timestamp_ns}"
        img_path = self.out_dir / f"{base}.jpg"
        ovl_path = self.out_dir / f"{base}_overlay.jpg"
        if frame_bgr is not None:
            _imwrite(img_path, frame_bgr)
        if overlay_bgr is not None:
            _imwrite(ovl_path, overlay_bgr)
        payload = {
            "camera_id": camera_id,
            "timestamp_ns": int(timestamp_ns),
            "findings": findings,
            "metrics": metrics,
            "image": str(img_path.resolve()),
            "overlay": str(ovl_path.resolve()) if overlay_bgr is not None else "",
        }
        (self.out_dir / f"{base}.json").write_text(
            json.dumps(payload, ensure_ascii=False, indent=2), encoding="utf-8")
        if self.mqtt_enabled and self.client is not None:
            self.client.publish(self.mqtt_topic, json.dumps(payload, ensure_ascii=False))
        return payload


@dataclass
class EventOutputConfig:
    """Reference EventConfig (event_output.py:22-39)."""
    output_dir: str = "./events"
    save_raw_image: bool = True
    save_overlay_image: bool = True
    save_jsonl: bool = True
    jsonl_filename: str = "inspection_events.jsonl"
    image_format: str = ".jpg"
    jpeg_quality: int = 95
    raw_subdir: str = "raw"
    overlay_subdir: str = "overlay"
    ok_subdir: str = "ok"
    ng_subdir: str = "ng"


class InspectionEventLogger:
    """Window-event logger: OK/NG image buckets + JSONL + summary
    (reference event_output.py:42-245)."""

    def __init__(self, config: Optional[EventOutputConfig] = None):
        self.config = config or EventOutputConfig()
        self.output_dir = Path(self.config.output_dir)
        self.ok_dir = self.output_dir / self.config.ok_subdir
        self.ng_dir = self.output_dir / self.config.ng_subdir
        for d in (self.ok_dir, self.ng_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.jsonl_path = self.output_dir / self.config.jsonl_filename

    def log_event(self, decision, window_stats, frame_bgr=None, overlay_bgr=None,
                  camera_id: str = "cam0") -> Dict[str, Any]:
        filename = f"{datetime.datetime.now():%Y%m%d_%H%M%S}_{decision.window_id}"
        subdir = self.ok_dir if decision.result == "OK" else self.ng_dir
        image_paths: Dict[str, str] = {}
        if self.config.save_raw_image and frame_bgr is not None:
            p = subdir / self.config.raw_subdir / f"{filename}{self.config.image_format}"
            p.parent.mkdir(parents=True, exist_ok=True)
            _imwrite(p, frame_bgr, self.config.jpeg_quality)
            image_paths["raw_image"] = str(p)
        if self.config.save_overlay_image and overlay_bgr is not None:
            p = subdir / self.config.overlay_subdir / f"{filename}{self.config.image_format}"
            p.parent.mkdir(parents=True, exist_ok=True)
            _imwrite(p, overlay_bgr, self.config.jpeg_quality)
            image_paths["overlay_image"] = str(p)

        record = {
            "window_id": decision.window_id,
            "timestamp": decision.timestamp,
            "camera_id": camera_id,
            "result": decision.result,
            "severity": decision.severity,
            "reasons": decision.reasons,
            "metrics": decision.metrics,
            "window_info": {
                "start_time_ns": window_stats.start_time_ns,
                "end_time_ns": window_stats.end_time_ns,
                "num_frames": window_stats.num_frames,
                "duration_sec": (window_stats.end_time_ns - window_stats.start_time_ns) / 1e9,
            },
            "images": image_paths,
        }
        if self.config.save_jsonl:
            with open(self.jsonl_path, "a", encoding="utf-8") as f:
                json.dump(record, f, ensure_ascii=False)
                f.write("\n")
        return record

    def get_summary(self) -> Dict[str, Any]:
        counts = {"total_events": 0, "ok_count": 0, "ng_count": 0,
                  "p1_count": 0, "p2_count": 0}
        if not self.jsonl_path.exists():
            return counts
        with open(self.jsonl_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                ev = json.loads(line)
                counts["total_events"] += 1
                if ev.get("result") == "OK":
                    counts["ok_count"] += 1
                else:
                    counts["ng_count"] += 1
                    counts["p1_count" if ev.get("severity") == "P1" else "p2_count"] += 1
        counts["ng_rate"] = round(
            counts["ng_count"] / max(counts["total_events"], 1) * 100, 2)
        return counts

    def print_summary(self) -> None:
        s = self.get_summary()
        print("\n" + "=" * 60)
        print("Inspection Event Summary")
        print("=" * 60)
        print(f"Total Events: {s['total_events']}")
        print(f"OK Count: {s['ok_count']}")
        print(f"NG Count: {s['ng_count']}")
        print(f"  - P1 (Critical): {s['p1_count']}")
        print(f"  - P2 (Warning): {s['p2_count']}")
        print(f"NG Rate: {s.get('ng_rate', 0)}%")
        print("=" * 60)


def format_reasons_readable(reasons: List[str]) -> str:
    """Human-readable reason summary (reference event_output.py:260-298)."""
    if not reasons:
        return "Normal"
    table = [("thickness_insufficient", "厚度不足"), ("thickness_low_average", "平均厚度偏低"),
             ("bulge_detected", "鼓包异常"), ("bulge_p95_exceeded", "局部厚度偏高"),
             ("wrap_uneven", "缠绕不均匀"), ("tape_low_coverage", "胶带覆盖率低"),
             ("tape_excessive_holes", "胶带孔洞过多"), ("tape_fragmented", "胶带断裂/脱落"),
             ("cable_defect_detected", "电缆损伤")]
    out = []
    for reason in reasons:
        for key, label in table:
            if key in reason:
                out.append(label)
                break
        else:
            out.append(reason)
    return "; ".join(out)


class AnomalyLogger:
    """CSV anomaly log (reference src/utils/logger.py:13-92)."""

    FIELDS = ["timestamp", "defect_type", "bbox_xmin", "bbox_ymin",
              "bbox_xmax", "bbox_ymax", "area_pixels"]

    def __init__(self, log_path: str = "log/events.log"):
        self.log_path = log_path
        Path(log_path).parent.mkdir(parents=True, exist_ok=True)
        if not os.path.exists(log_path):
            with open(log_path, "w", newline="") as f:
                csv.writer(f).writerow(self.FIELDS)

    def log_event(self, timestamp: str, defect_type: str,
                  bbox: Tuple[int, int, int, int], area_pixels: int = None) -> None:
        with open(self.log_path, "a", newline="") as f:
            csv.writer(f).writerow([timestamp, defect_type, *bbox,
                                    area_pixels if area_pixels is not None else -1])

    def read_log(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.log_path):
            return []
        out = []
        with open(self.log_path, newline="") as f:
            for row in csv.DictReader(f):
                if row:
                    out.append({
                        "timestamp": row["timestamp"],
                        "defect_type": row["defect_type"],
                        "bbox": (int(row["bbox_xmin"]), int(row["bbox_ymin"]),
                                 int(row["bbox_xmax"]), int(row["bbox_ymax"])),
                        "area_pixels": None if row["area_pixels"] == "-1"
                        else int(row["area_pixels"]),
                    })
        return out


class JSONLogger:
    """Per-event JSON files (reference src/utils/logger.py:95-146)."""

    def __init__(self, log_dir: str = "log/events"):
        self.log_dir = log_dir
        Path(log_dir).mkdir(parents=True, exist_ok=True)

    def save_event(self, camera_id: str, timestamp_ns: int, findings: List[dict],
                   metrics: dict = None, image_paths: dict = None) -> str:
        event = {
            "camera_id": camera_id,
            "timestamp_ns": timestamp_ns,
            "timestamp": datetime.datetime.now().isoformat(),
            "findings": findings,
            "metrics": metrics or {},
            "images": image_paths or {},
        }
        name = f"{datetime.datetime.now():%Y%m%d_%H%M%S_%f}"[:-3] + "_event.json"
        path = os.path.join(self.log_dir, name)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(event, f, indent=2, ensure_ascii=False)
        return path


class StatisticsLogger:
    """Periodic statistics CSV (reference src/utils/logger.py:149-194)."""

    def __init__(self, log_path: str = "log/statistics.csv"):
        self.log_path = log_path
        Path(log_path).parent.mkdir(parents=True, exist_ok=True)
        if not os.path.exists(log_path):
            with open(log_path, "w", newline="") as f:
                csv.writer(f).writerow(["timestamp", "total_frames",
                                        "frames_with_defects", "detection_rate",
                                        "avg_processing_time_ms"])

    def log_statistics(self, total_frames: int, frames_with_defects: int,
                       avg_processing_time_ms: float) -> None:
        rate = frames_with_defects / total_frames if total_frames else 0.0
        with open(self.log_path, "a", newline="") as f:
            csv.writer(f).writerow([
                datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                total_frames, frames_with_defects,
                f"{rate:.4f}", f"{avg_processing_time_ms:.2f}"])
