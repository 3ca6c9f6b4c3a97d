"""TensorBoard event-file writer (hand-rolled TFRecord + Summary protos):
the port's own copy of `mspi_tpu/utils/tensorboard.py`, whose weight
histograms here read a torch module's named parameters.

Reference capability: SlowFast/slowfast/visualization/tensorboard_vis.py:20-
429 (TensorboardWriter: add_scalars, plot_eval/confusion-matrix figures,
histograms, video/image summaries).

No TensorFlow dependency: events are encoded with a minimal protobuf wire
encoder + CRC32C-framed TFRecords, readable by any standard TensorBoard
install.  Scalars, histograms, images (PNG via cv2) and text are supported.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np

# ------------------------------------------------------------------ crc32c

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# --------------------------------------------------------- protobuf encoder

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _string_field(field: int, s: str) -> bytes:
    return _bytes_field(field, s.encode("utf-8"))


def _double_field(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _packed_doubles(field: int, values: Sequence[float]) -> bytes:
    data = b"".join(struct.pack("<d", float(v)) for v in values)
    return _bytes_field(field, data)


# Summary.Value field numbers (tensorboard/compat/proto/summary.proto):
#   tag=1, simple_value=2, image=4, histo=5, tensor=8, metadata=9
# Image: height=1, width=2, colorspace=3, encoded_image_string=4
# HistogramProto: min=1, max=2, num=3, sum=4, sum_squares=5,
#   bucket_limit=6 (packed), bucket=7 (packed)
# Event: wall_time=1, step=2, file_version=3, summary=5


def _scalar_value(tag: str, value: float) -> bytes:
    return _bytes_field(1, _string_field(1, tag) + _float_field(2, float(value)))


def _histo_value(tag: str, values: np.ndarray, bins: int = 30) -> bytes:
    values = np.asarray(values, np.float64).ravel()
    counts, edges = np.histogram(values, bins=bins)
    h = (_double_field(1, float(values.min())) +
         _double_field(2, float(values.max())) +
         _double_field(3, float(values.size)) +
         _double_field(4, float(values.sum())) +
         _double_field(5, float(np.square(values).sum())) +
         _packed_doubles(6, edges[1:]) +
         _packed_doubles(7, counts))
    return _bytes_field(1, _string_field(1, tag) + _bytes_field(5, h))


def _image_value(tag: str, image: np.ndarray) -> bytes:
    """image: [H, W, 3] uint8 RGB."""
    import cv2

    ok, png = cv2.imencode(".png", image[:, :, ::-1])  # cv2 wants BGR
    assert ok
    img = (_int_field(1, image.shape[0]) + _int_field(2, image.shape[1]) +
           _int_field(3, 3) + _bytes_field(4, bytes(png.tobytes())))
    return _bytes_field(1, _string_field(1, tag) + _bytes_field(4, img))


def _render_confusion_matrix(cmtx: np.ndarray,
                             class_names: Optional[Sequence[str]] = None,
                             cell: int = 16) -> np.ndarray:
    """Confusion matrix -> RGB uint8 image.

    Matplotlib path mirrors the reference figure (tensorboard_vis.py:165-230):
    Blues colormap, class-name ticks, per-cell counts colored by luminance.
    Falls back to a dependency-free heatmap when matplotlib is unavailable.
    """
    cm = np.asarray(cmtx, np.float64)
    n = cm.shape[0]
    if class_names is None:
        class_names = [str(i) for i in range(n)]
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(max(4.0, n * 0.5),) * 2, dpi=100)
        im = ax.imshow(cm, interpolation="nearest", cmap="Blues")
        fig.colorbar(im, ax=ax, fraction=0.046)
        ax.set(xticks=np.arange(n), yticks=np.arange(n),
               xticklabels=class_names, yticklabels=class_names,
               ylabel="True label", xlabel="Predicted label",
               title="Confusion Matrix")
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
        thresh = cm.max() / 2.0 if cm.max() > 0 else 0.5
        if n <= 32:  # per-cell counts unreadable beyond this
            for i in range(n):
                for j in range(n):
                    ax.text(j, i, format(int(cm[i, j]), "d"), ha="center",
                            va="center",
                            color="white" if cm[i, j] > thresh else "black")
        fig.tight_layout()
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
        plt.close(fig)
        return img
    except ImportError:
        denom = cm.max() if cm.max() > 0 else 1.0
        norm = cm / denom
        r = np.clip(norm * 2.0 - 0.5, 0, 1)
        g = np.clip(norm * 1.5, 0, 1)
        b = np.clip(1.0 - norm, 0, 1)
        img = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
        return np.repeat(np.repeat(img, cell, 0), cell, 1)


def _event(step: int, summary_values: bytes = b"",
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    ev = _double_field(1, wall_time if wall_time is not None else time.time())
    ev += _int_field(2, int(step))
    if file_version is not None:
        ev += _string_field(3, file_version)
    if summary_values:
        ev += _bytes_field(5, summary_values)
    return ev


class SummaryWriter:
    """Minimal-but-standard TensorBoard writer.

    Usage mirrors torch.utils.tensorboard / the reference's
    TensorboardWriter: add_scalar(s) / add_histogram / add_image /
    add_confusion_matrix, flush, close.
    """

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        self._lock = threading.Lock()
        self._write_record(_event(0, file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        with self._lock:
            self._f.write(header)
            self._f.write(struct.pack("<I", _masked_crc(header)))
            self._f.write(data)
            self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_event(step, _scalar_value(tag, value)))

    def add_scalars(self, scalars: Dict[str, float], step: int):
        """tensorboard_vis.py TensorboardWriter.add_scalars(data_dict)."""
        vals = b"".join(_scalar_value(k, v) for k, v in scalars.items())
        self._write_record(_event(step, vals))

    def add_histogram(self, tag: str, values, step: int, bins: int = 30):
        self._write_record(_event(step, _histo_value(tag, np.asarray(values),
                                                     bins)))

    def add_image(self, tag: str, image: np.ndarray, step: int):
        self._write_record(_event(step, _image_value(tag, image)))

    def add_confusion_matrix(self, tag: str, cmtx: np.ndarray, step: int,
                             class_names: Optional[Sequence[str]] = None,
                             cell: int = 16):
        """Render a confusion matrix as an image summary (the reference's
        tensorboard_vis.py:165-230 plot_confusion_matrix, which draws a
        matplotlib figure with class ticks + per-cell counts).  Uses
        matplotlib when importable; otherwise falls back to a dependency-free
        heatmap upscaled to `cell` pixels per entry."""
        img = _render_confusion_matrix(cmtx, class_names, cell)
        self.add_image(tag, img, step)

    def add_weight_histograms(self, model, step: int, prefix: str = "weights"):
        """Per-parameter histograms of a torch module (tensorboard_vis.py
        plot_weights_and_activations capability), tagged by the parameters'
        names with '/' for '.'."""
        for name, p in model.named_parameters():
            self.add_histogram(f"{prefix}/{name.replace('.', '/')}",
                               p.detach().float().cpu().numpy(), step)

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        self.flush()
        self._f.close()
