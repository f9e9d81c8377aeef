"""Parameter-server subsystem of the port.

Counterpart of ``hetu_tpu/ps/``: the C++ host-side key-value server
with typed requests (dense and sparse push/pull, server-side
optimizers, bounded-staleness embedding sync, save/load) over TCP
(``native/``, the same sources as the JAX package's, so the two
packages speak one wire protocol), its ctypes client
(:mod:`.client`), server process management (:mod:`.server`), the
device-resident embedding cache (:mod:`.device_cache`) and the
executor-side runtime that schedules pushes and pulls around each step
(:mod:`.runtime`).
"""
