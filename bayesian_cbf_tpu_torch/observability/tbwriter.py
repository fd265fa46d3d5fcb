"""Tensorboard event files: a writer and a reader.

The reference's artifacts are tfevents files: scalar channels and
TensorProto summaries of per-step state (bayes_cbf/misc.py:320-359
`make_tensor_summary` / `add_tensors`, read back by
`load_tensorboard_scalars`).  `TensorboardWriter` writes runs that the
reference's loaders, tensorboard itself or any tfevents tool read, through
tensorboard's pure-Python `EventFileWriter` and proto classes (no
TensorFlow).  `tensorboard` is imported inside the functions: asking for
this backend where it is not installed raises ImportError.
"""
from __future__ import annotations

import time

import numpy as np


def _host(value):
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float32)


class TensorboardWriter:
    """Minimal tfevents sink: add_scalar / add_tensor / flush / close.

    Tags and payload conventions match the reference logger so its
    offline analyses (trigger_interval.py, visualize/) can consume our
    runs unchanged: scalars as simple_value summaries, arrays as
    DT_FLOAT TensorProto summaries with explicit shape (the
    make_tensor_summary layout, misc.py:320-334)."""

    def __init__(self, logdir: str):
        from tensorboard.summary.writer.event_file_writer import (
            EventFileWriter)
        from tensorboard.compat.proto import (event_pb2, summary_pb2,
                                              tensor_pb2,
                                              tensor_shape_pb2)
        self._event_pb2 = event_pb2
        self._summary_pb2 = summary_pb2
        self._tensor_pb2 = tensor_pb2
        self._shape_pb2 = tensor_shape_pb2
        self._writer = EventFileWriter(logdir)

    def _emit(self, summary, step):
        ev = self._event_pb2.Event(wall_time=time.time(),
                                   step=int(step), summary=summary)
        self._writer.add_event(ev)

    def add_scalar(self, tag: str, value, step: int):
        s = self._summary_pb2.Summary()
        s.value.add(tag=str(tag), simple_value=float(_host(value)))
        self._emit(s, step)

    def add_tensor(self, tag: str, value, step: int):
        arr = _host(value)
        shape = self._shape_pb2.TensorShapeProto(
            dim=[self._shape_pb2.TensorShapeProto.Dim(size=int(d))
                 for d in arr.shape])
        # float_val (repeated field), NOT tensor_content: the reference's
        # readers (misc.py:348-350 stream_tensorboard_scalars) reshape
        # tensor.float_val only and would see an empty array otherwise.
        tp = self._tensor_pb2.TensorProto(
            dtype=1,  # DT_FLOAT — the reference logs float32 tensors
            tensor_shape=shape,
            float_val=arr.reshape(-1).tolist())
        s = self._summary_pb2.Summary()
        s.value.add(tag=str(tag), tensor=tp)
        self._emit(s, step)

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


def load_tensorboard_scalars(run_dir: str):
    """Read a tfevents run back into {tag: [(step, value), ...]} —
    scalars as floats, tensor summaries as float32 ndarrays (the
    reference's load_tensorboard_scalars contract, misc.py:343-359)."""
    from tensorboard.backend.event_processing import event_file_loader
    import os

    out = {}
    files = sorted(
        os.path.join(run_dir, f) for f in os.listdir(run_dir)
        if "tfevents" in f)
    for path in files:
        for ev in event_file_loader.LegacyEventFileLoader(path).Load():
            if not ev.HasField("summary"):
                continue
            for v in ev.summary.value:
                if v.HasField("simple_value"):
                    item = float(v.simple_value)
                elif v.HasField("tensor"):
                    t = v.tensor
                    shape = tuple(d.size for d in t.tensor_shape.dim)
                    if t.tensor_content:
                        item = np.frombuffer(
                            t.tensor_content, np.float32).reshape(shape)
                    else:
                        item = np.asarray(t.float_val,
                                          np.float32).reshape(shape)
                else:
                    continue
                out.setdefault(v.tag, []).append((int(ev.step), item))
    return out
