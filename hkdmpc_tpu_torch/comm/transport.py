"""ctypes bindings of the native transport `csrc/hkdcomm.cpp`: UDP-multicast
publish / subscribe in the LCM wire format — port of
`hkdmpc_tpu/comm/transport.py`.

The C++ source is the port's own copy (`tests/test_torch_comm.py` pins it
byte-equal to the JAX package's). g++ builds it at first use into
`build/hkdmpc_tpu_torch/<hash>/` (`ops/_build.build_host`); a failed build
raises, and nothing takes the library's place. URL format as in the
reference: udpm://239.255.76.67:7667?ttl=N (common/utilities.h:303-306).

`receive` waits inside the native library, which ctypes enters with the
interpreter lock released: a thread that polls the transport does not hold
up a thread that launches kernels.
"""

from __future__ import annotations

import ctypes
import re

DEFAULT_URL = "udpm://239.255.76.67:7667?ttl=255"
_URL = re.compile(r"udpm://([\d.]+):(\d+)(?:\?ttl=(\d+))?")
CHANNEL_CAP = 256
MESSAGE_CAP = 1 << 20   # bytes: the largest message `receive` hands over

_lib = None


def _library() -> ctypes.CDLL:
    """The native library, built and loaded once per process."""
    global _lib
    if _lib is None:
        from hkdmpc_tpu_torch.ops import _build
        lib = ctypes.CDLL(str(_build.build_host("hkdcomm")))
        vp, cp, ci = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        for name, restype, argtypes in (
                ("hkdcomm_create", vp, [cp, ci, ci]),
                ("hkdcomm_destroy", None, [vp]),
                ("hkdcomm_publish", ci, [vp, cp, cp, ci]),
                ("hkdcomm_subscribe", None, [vp, cp]),
                ("hkdcomm_receive", ci, [vp, cp, ci, cp, ci, ci]),
                ("hkdcomm_bind_ok", ci, [vp]),
                ("hkdcomm_stats", None,
                 [vp, ctypes.POINTER(ctypes.c_ulonglong)])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


class LCMTransport:
    """LCM-wire-compatible UDP multicast pub/sub."""

    def __init__(self, url: str = DEFAULT_URL):
        self._h = None
        m = _URL.match(url)
        if not m:
            raise ValueError(f"bad udpm url: {url}")
        addr, port, ttl = m.group(1), int(m.group(2)), int(m.group(3) or 0)
        self._lib = _library()
        self._h = self._lib.hkdcomm_create(addr.encode(), port, ttl)
        self._chan = ctypes.create_string_buffer(CHANNEL_CAP)
        self._data = ctypes.create_string_buffer(MESSAGE_CAP)

    def publish(self, channel: str, data: bytes) -> None:
        rc = self._lib.hkdcomm_publish(self._h, channel.encode(), data,
                                       len(data))
        if rc != 0:
            raise IOError(f"publish to {channel} failed")

    def subscribe(self, channel: str) -> None:
        self._lib.hkdcomm_subscribe(self._h, channel.encode())

    def receive(self, timeout_ms: int = 100):
        """(channel, bytes) of the next message of a subscribed channel, or
        None after timeout_ms. One thread at a time: the receive buffers
        belong to the transport."""
        n = self._lib.hkdcomm_receive(self._h, self._chan, CHANNEL_CAP,
                                      self._data, MESSAGE_CAP, timeout_ms)
        if n < 0:
            return None
        return self._chan.value.decode(), ctypes.string_at(self._data, n)

    def stats(self) -> dict:
        """The native transport's loss counters: messages dropped on
        receive-queue overflow, and partial fragment reassemblies evicted
        (fragmented messages lost in flight)."""
        out = (ctypes.c_ulonglong * 2)()
        self._lib.hkdcomm_stats(self._h, out)
        return {"queue_drops": int(out[0]), "frag_evictions": int(out[1])}

    def close(self) -> None:
        if self._h:
            self._lib.hkdcomm_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
