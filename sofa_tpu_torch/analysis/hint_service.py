"""The gRPC advice service: remote hints on a feature vector (the JAX
package's ``sofa_tpu/analysis/hint_service.py``), client and server.

The wire format is ``sofa_tpu/native/hint.proto``'s, encoded by hand here
(proto3: ``HintRequest{string hostname = 1; map<string, double> features
= 2}``, ``HintResponse{repeated string hints = 1}``), so that the port
needs no protobuf.  The encoder writes the map entries in key order, a
decoder takes them in any order and skips fields it does not know.
``grpc`` is imported only by the calls that talk: without ``grpcio`` a
configured server ends in the same one-line warning as an unreachable one.

Server:  python -m sofa_tpu_torch.analysis.hint_service [port]
Client:  analyze --hint_server host:port  (or ``SOFA_HINT_SERVER``)
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

SERVICE = "sofa_tpu.hint.HintService"
METHOD = f"/{SERVICE}/Hint"

# Separate connect and read deadlines, so that a dead host fails in
# seconds; both can be set from the environment for slow links.
DEFAULT_CONNECT_TIMEOUT_S = 3.0
DEFAULT_READ_TIMEOUT_S = 5.0


# --- the proto3 codec -------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_request(hostname: str, features: Dict[str, float]) -> bytes:
    """A HintRequest: the hostname (omitted when empty, as proto3 omits a
    default), then one map entry per feature in key order, each with its
    key and its double value."""
    out = bytearray()
    if hostname:
        out += _len_field(1, hostname.encode())
    for name in sorted(features):
        entry = _len_field(1, name.encode()) + b"\x11" + struct.pack(
            "<d", float(features[name]))
        out += _len_field(2, entry)
    return bytes(out)


def encode_response(hints: List[str]) -> bytes:
    return b"".join(_len_field(1, h.encode()) for h in hints)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = value = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[i]
        i += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, i
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _fields(buf: bytes):
    """(field number, wire type, value) of each field: an int for a
    varint, bytes for the fixed and length-delimited types."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, i = buf[i:i + n], i + n
            if len(value) != n:
                raise ValueError("truncated fixed field")
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
            if len(value) != n:
                raise ValueError("truncated length-delimited field")
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def decode_request(buf: bytes) -> Tuple[str, Dict[str, float]]:
    hostname, features = "", {}
    for field, wire, value in _fields(buf):
        if field == 1 and wire == 2:
            hostname = value.decode()
        elif field == 2 and wire == 2:
            key, val = "", 0.0
            for f, w, v in _fields(value):
                if f == 1 and w == 2:
                    key = v.decode()
                elif f == 2 and w == 1:
                    val = struct.unpack("<d", v)[0]
            features[key] = val
    return hostname, features


def decode_response(buf: bytes) -> List[str]:
    return [value.decode() for field, wire, value in _fields(buf)
            if field == 1 and wire == 2]


# --- the client -------------------------------------------------------------

def _env_timeout(var: str, default: float) -> float:
    raw = os.environ.get(var, "").strip()
    try:
        val = float(raw) if raw else default
    except ValueError:
        return default
    return val if val > 0 else default


def discover_server(cfg) -> Optional[str]:
    if cfg.hint_server:
        return cfg.hint_server
    return os.environ.get("SOFA_HINT_SERVER")


def request_hints(server: str, features, hostname: str = "",
                  timeout: Optional[float] = None,
                  connect_timeout: Optional[float] = None) -> List[str]:
    """One Hint call to ``server`` (port 50051 unless given), bounded by
    the connect and read deadlines (``SOFA_HINT_CONNECT_TIMEOUT_S``,
    ``SOFA_HINT_TIMEOUT_S``)."""
    import grpc

    if timeout is None:
        timeout = _env_timeout("SOFA_HINT_TIMEOUT_S",
                               DEFAULT_READ_TIMEOUT_S)
    if connect_timeout is None:
        connect_timeout = _env_timeout("SOFA_HINT_CONNECT_TIMEOUT_S",
                                       DEFAULT_CONNECT_TIMEOUT_S)
    if ":" not in server:
        server += ":50051"
    vector = {name: float(value) for name, value
              in features.to_frame().itertuples(index=False)}
    request = (hostname or os.uname().nodename, vector)
    with grpc.insecure_channel(server) as channel:
        grpc.channel_ready_future(channel).result(timeout=connect_timeout)
        call = channel.unary_unary(
            METHOD, request_serializer=lambda r: encode_request(*r),
            response_deserializer=decode_response)
        return list(call(request, timeout=timeout))


def fetch_hints(cfg, features) -> List[str]:
    """What analyze calls: the configured server's hints, or [] with a
    warning when it cannot be asked (unreachable, wedged, or no
    ``grpcio``); nothing at all when no server is configured."""
    from sofa_tpu_torch.printing import print_warning

    server = discover_server(cfg)
    if not server:
        return []
    try:
        return request_hints(server, features)
    except Exception as e:  # noqa: BLE001 - remote advice is best-effort
        print_warning(f"hint server {server}: {type(e).__name__}: {e} — "
                      "continuing without remote hints")
        return []


# --- the server -------------------------------------------------------------

def serve(port: int = 50051, block: bool = True):
    """Run the advice server: the local rule engine over whatever feature
    vector a client sends.  Returns (server, bound port)."""
    from concurrent import futures

    import grpc

    from sofa_tpu_torch.analysis.advice import generate_hints
    from sofa_tpu_torch.analysis.features import Features
    from sofa_tpu_torch.config import SofaConfig

    def hint_handler(request, context) -> List[str]:
        _hostname, vector = request
        features = Features()
        for name, value in vector.items():
            features.add(name, value)
        hints = generate_hints(features, SofaConfig())
        return hints or ["no obvious bottleneck in the submitted feature "
                         "vector"]

    handler = grpc.method_handlers_generic_handler(SERVICE, {
        "Hint": grpc.unary_unary_rpc_method_handler(
            hint_handler, request_deserializer=decode_request,
            response_serializer=encode_response)})
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((handler,))
    bound = server.add_insecure_port(f"[::]:{port}")
    server.start()
    print(f"sofa_tpu_torch hint service listening on :{bound}", flush=True)
    if block:
        server.wait_for_termination()
    return server, bound


if __name__ == "__main__":
    import sys

    serve(int(sys.argv[1]) if len(sys.argv) > 1 else 50051)
