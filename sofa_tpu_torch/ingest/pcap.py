"""Pure-Python pcap ingest for DCN/host network traffic.

Parsing the pcap file directly removes the tcpdump dependency at report
time (the capture machine and the analysis machine are often different).

Supports classic pcap (µs and ns magic, both endians) with link types
Ethernet(1), RAW-IP(101), Linux SLL(113) and SLL2(276) — tcpdump -i any
writes SLL/SLL2.  IPv4 AND IPv6 (ethertype 0x86DD) TCP/UDP packets become
rows:

  payload  = captured original length (bytes)
  pkt_src/dst = packed IPv4 (trace.packed_ip encoding) for v4; interned
             integer id (>= trace.V6_ID_BASE) for v6, with the id ->
             literal mapping written to net_addrs.csv beside the capture
  duration = payload / 128 MB/s, a fixed service-rate model kept for
             comparability with the JAX package's frames
  name     = "proto sport->dport"
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import pandas as pd

from sofa_tpu_torch.trace import (V6_ID_BASE, empty_frame, make_frame,
                                  packed_ip, write_net_addrs)

_NET_MODEL_BYTES_PER_S = 128e6

_MAGICS = {
    0xA1B2C3D4: ("<", 1e-6), 0xD4C3B2A1: (">", 1e-6),
    0xA1B23C4D: ("<", 1e-9), 0x4D3CB2A1: (">", 1e-9),
}


def _ipv4_row(ts: float, data: bytes, orig_len: int, time_base: float) -> Optional[dict]:
    if len(data) < 20 or (data[0] >> 4) != 4:
        return None
    ihl = (data[0] & 0x0F) * 4
    proto = data[9]
    src = ".".join(str(b) for b in data[12:16])
    dst = ".".join(str(b) for b in data[16:20])
    sport = dport = 0
    pname = {6: "tcp", 17: "udp"}.get(proto, str(proto))
    if proto in (6, 17) and len(data) >= ihl + 4:
        sport, dport = struct.unpack("!HH", data[ihl:ihl + 4])
    return {
        "timestamp": ts - time_base,
        "event": float(dport or proto),
        "duration": orig_len / _NET_MODEL_BYTES_PER_S,
        "payload": orig_len,
        "bandwidth": _NET_MODEL_BYTES_PER_S,
        "pkt_src": packed_ip(src),
        "pkt_dst": packed_ip(dst),
        "name": f"{pname} {src}:{sport}->{dst}:{dport}",
        "device_kind": "net",
    }


# IPv6 extension headers that sit between the fixed header and the L4
# payload; each is (next-header, length) framed except fragment's fixed 8.
_V6_EXT_HEADERS = {0, 43, 44, 51, 60}  # hop-by-hop, routing, frag, AH, dstopt


class _AddrIntern:
    """Literal IPv6 address -> stable integer id (>= V6_ID_BASE), assigned in
    first-seen order so the same capture always produces the same table."""

    def __init__(self):
        self.ids: dict = {}

    def __call__(self, literal: str) -> int:
        hit = self.ids.get(literal)
        if hit is None:
            hit = V6_ID_BASE + len(self.ids)
            self.ids[literal] = hit
        return hit


def _ipv6_row(ts: float, data: bytes, orig_len: int, time_base: float,
              intern: _AddrIntern) -> Optional[dict]:
    if len(data) < 40 or (data[0] >> 4) != 6:
        return None
    import ipaddress

    proto = data[6]  # next header
    src = ipaddress.IPv6Address(data[8:24]).compressed
    dst = ipaddress.IPv6Address(data[24:40]).compressed
    # walk extension headers to the transport header (bounded: each hop
    # must advance, and the chain set is closed)
    off = 40
    hops = 0
    while proto in _V6_EXT_HEADERS and len(data) >= off + 8 and hops < 8:
        nxt = data[off]
        if proto == 44:  # fragment: fixed 8 bytes
            ext_len = 8
        elif proto == 51:  # AH counts 32-bit words minus 2
            ext_len = (data[off + 1] + 2) * 4
        else:  # hop-by-hop / routing / dstopts count 8-byte units minus 1
            ext_len = (data[off + 1] + 1) * 8
        proto, off, hops = nxt, off + ext_len, hops + 1
    sport = dport = 0
    pname = {6: "tcp6", 17: "udp6"}.get(proto, f"v6:{proto}")
    if proto in (6, 17) and len(data) >= off + 4:
        sport, dport = struct.unpack("!HH", data[off:off + 4])
    return {
        "timestamp": ts - time_base,
        "event": float(dport or proto),
        "duration": orig_len / _NET_MODEL_BYTES_PER_S,
        "payload": orig_len,
        "bandwidth": _NET_MODEL_BYTES_PER_S,
        "pkt_src": intern(src),
        "pkt_dst": intern(dst),
        "name": f"{pname} [{src}]:{sport}->[{dst}]:{dport}",
        "device_kind": "net",
    }


def parse_pcap_bytes(blob: bytes, time_base: float = 0.0,
                     intern: "Optional[_AddrIntern]" = None) -> pd.DataFrame:
    if len(blob) < 24:
        return empty_frame()
    magic = struct.unpack("<I", blob[:4])[0]
    if magic not in _MAGICS:
        magic = struct.unpack(">I", blob[:4])[0]
    if magic not in _MAGICS:
        return empty_frame()
    endian, tick = _MAGICS[magic]
    linktype = struct.unpack(endian + "I", blob[20:24])[0] & 0x0FFFFFFF
    if intern is None:
        intern = _AddrIntern()
    rows: List[dict] = []
    off = 24
    n = len(blob)
    _IP_ETHERTYPES = (0x0800, 0x86DD)
    while off + 16 <= n:
        ts_sec, ts_frac, incl, orig = struct.unpack(endian + "IIII", blob[off:off + 16])
        off += 16
        if off + incl > n:
            break
        data = blob[off:off + incl]
        off += incl
        ts = ts_sec + ts_frac * tick
        ip: Optional[bytes] = None
        if linktype == 1 and len(data) >= 14:  # Ethernet
            if struct.unpack("!H", data[12:14])[0] in _IP_ETHERTYPES:
                ip = data[14:]
        elif linktype == 101:  # raw IP, version from the first nibble
            ip = data
        elif linktype == 113 and len(data) >= 16:  # Linux cooked (SLL)
            if struct.unpack("!H", data[14:16])[0] in _IP_ETHERTYPES:
                ip = data[16:]
        elif linktype == 276 and len(data) >= 20:  # SLL2
            if struct.unpack("!H", data[0:2])[0] in _IP_ETHERTYPES:
                ip = data[20:]
        if ip is None or not ip:
            continue
        version = ip[0] >> 4
        row = (_ipv4_row(ts, ip, orig, time_base) if version == 4
               else _ipv6_row(ts, ip, orig, time_base, intern)
               if version == 6 else None)
        if row:
            rows.append(row)
    return make_frame(rows) if rows else empty_frame()


def ingest_pcap(path: str, time_base: float = 0.0) -> pd.DataFrame:
    """File-level ingest.  A non-empty file that cannot be a pcap (a
    truncated global header or an unknown magic) raises ValueError; an
    empty file (tcpdump launched, zero packets flushed) and a truncated
    trailing packet (capture killed mid-write) stay benign:
    parse_pcap_bytes keeps whatever decoded.  IPv6 ids are written to
    net_addrs.csv beside the capture."""
    if not os.path.isfile(path):
        return empty_frame()
    intern = _AddrIntern()
    with open(path, "rb") as f:
        blob = f.read()
    if blob:
        if len(blob) < 24:
            raise ValueError(f"{path}: truncated pcap global header "
                             f"({len(blob)} bytes)")
        magic_le = struct.unpack("<I", blob[:4])[0]
        magic_be = struct.unpack(">I", blob[:4])[0]
        if magic_le not in _MAGICS and magic_be not in _MAGICS:
            raise ValueError(f"{path}: not a pcap: bad magic "
                             f"0x{magic_le:08x}")
    df = parse_pcap_bytes(blob, time_base, intern=intern)
    write_net_addrs(intern.ids, os.path.dirname(path) or ".")
    return df
