"""Data loading (counterpart of ``hetu_tpu/dataloader.py``; reference:
python/hetu/dataloader.py).

A :class:`Dataloader` batches one in-memory numpy array; a
:class:`DataloaderOp` is a graph leaf that serves one dataloader per
subgraph name (``"train"``, ``"validate"``, or ``"default"`` for every
other name). The executor pulls the next batch of each dataloader op
once per run of a subgraph and counts a subgraph's batches as the
fewest its dataloaders give (``Executor.get_batch_num``).

Arrays are cast once: integers to int32 where their values fit and to
int64 where they do not, everything else to float32. The graph of a
multi-graph loader (``GNNDataLoaderOp``) comes with ``models/gnn.py``.
"""
from __future__ import annotations

import numpy as np

from .graph.node import Op

__all__ = ["Dataloader", "DataloaderOp", "dataloader_op"]


class Dataloader:
    """Batches of ``batch_size`` rows of ``func(raw_data)``, in order or
    reshuffled at every epoch (``RandomState(epoch + 1)``); with
    ``drop_last`` a short last batch is never served."""

    def __init__(self, raw_data, batch_size, name="default", func=None,
                 drop_last=True, shuffle=False):
        self.func = func if func else (lambda x: x)
        arr = np.asarray(self.func(raw_data))
        if arr.dtype.kind in "iu":
            if arr.size == 0 or (arr.min() >= np.iinfo(np.int32).min
                                 and arr.max() <= np.iinfo(np.int32).max):
                arr = arr.astype(np.int32)
            else:
                arr = arr.astype(np.int64)
        else:
            arr = arr.astype(np.float32)
        self.raw_data = arr
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.name = str(name)
        self.inited = False

    def init_states(self):
        self.samples_num = len(self.raw_data)
        if self.batch_size <= 0:
            raise ValueError(f"dataloader {self.name}: batch size "
                             f"{self.batch_size} must be positive")
        if self.drop_last:
            self.batch_num = self.samples_num // self.batch_size
        else:
            self.batch_num = int(np.ceil(self.samples_num / self.batch_size))
        if self.batch_num <= 0:
            raise ValueError(f"dataloader {self.name}: {self.samples_num} "
                             f"samples make no batch of {self.batch_size}")
        self.seq = np.arange(self.samples_num)
        self.batch_index = 0
        self.epoch = 0
        self.inited = True
        self._maybe_reshuffle()

    def _maybe_reshuffle(self):
        if self.shuffle:
            np.random.RandomState(self.epoch + 1).shuffle(self.seq)

    def get_arr(self):
        """The next batch; the epoch ends after ``batch_num`` of them."""
        if not self.inited:
            self.init_states()
        start = self.batch_index * self.batch_size
        batch = self.raw_data[self.seq[start:start + self.batch_size]]
        self.batch_index += 1
        if self.batch_index >= self.batch_num:
            self.batch_index = 0
            self.epoch += 1
            self._maybe_reshuffle()
        return batch


class DataloaderOp(Op):
    """A graph leaf fed by the executor from the dataloader of the
    running subgraph's name."""

    def __init__(self, dataloaders):
        super().__init__(DataloaderOp, [], None)
        if isinstance(dataloaders, Dataloader):
            dataloaders = [dataloaders]
        self.dataloaders = {dl.name: dl for dl in dataloaders}
        self.name = "DataloaderOp%d(%s)" % (
            self.id, "/".join(self.dataloaders.keys()))

    def _dl(self, name):
        if name in self.dataloaders:
            return self.dataloaders[name]
        return self.dataloaders["default"]

    def get_batch_num(self, name):
        dl = self._dl(name)
        if not dl.inited:
            dl.init_states()
        return dl.batch_num

    def get_arr(self, name):
        return self._dl(name).get_arr()

    def compute(self, input_vals, ectx):
        raise AssertionError("dataloader values are fed by the executor")

    def gradient(self, output_grad):
        return None

    def infer_shape(self, input_shapes):
        raise AssertionError("a dataloader's shape is its batch's")


def dataloader_op(dataloaders):
    """A DataloaderOp from ``Dataloader`` objects or ``[data, batch_size,
    name?, func?, ...]`` lists (reference dataloader.py:176-190)."""
    return DataloaderOp([dl if isinstance(dl, Dataloader) else Dataloader(*dl)
                         for dl in dataloaders])
