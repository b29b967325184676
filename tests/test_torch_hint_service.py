"""The advice service of the port (``sofa_tpu_torch/analysis/
hint_service.py``) against the JAX package's: the hand-written proto3
codec byte for byte against ``hint_pb2`` (each field as protobuf writes
it, the map entries in key order), the port's client
against the JAX server and the JAX client against the port's server, both
over gRPC on localhost; and ``analyze`` with a server configured but no
``grpcio``, which must end in one warning, not a failed run."""

import math
import sys

import numpy as np
import pytest

from sofa_tpu.analysis import hint_service as jax_hs
from sofa_tpu.analysis.features import Features as JaxFeatures
from sofa_tpu.config import SofaConfig as JaxConfig
from sofa_tpu.ingest import hint_pb2
from sofa_tpu_torch.analysis import hint_service as hs
from sofa_tpu_torch.analysis.features import Features
from sofa_tpu_torch.config import SofaConfig


def _vectors():
    """Feature vectors made from a seed: the hint rules' names, odd names
    (empty, unicode, long), and values across the double range."""
    rng = np.random.default_rng(11)
    named = {"gpu0_step_gap_pct": 87.5, "gpu_kernels": 21798.0,
             "gpu_busy_pct": 12.25, "comm_ratio": 0.0, "cpu_util": 0.93,
             "num_cores": 8.0}
    odd = {"": -0.0, "λ_ünïcode": 1e-300, "x" * 300: -1e300,
           "inf_like": 1.7976931348623157e308, "tiny": 5e-324}
    random = {f"f{i}": float(v) for i, v in
              enumerate(rng.normal(0, 1e6, 200))}
    return {"named": named, "odd": odd, "random": random, "empty": {}}


@pytest.mark.parametrize("case", sorted(_vectors()))
@pytest.mark.parametrize("hostname", ["", "h100-node-7"])
def test_request_codec_matches_hint_pb2(case, hostname):
    vector = _vectors()[case]
    ref = hint_pb2.HintRequest(hostname=hostname)
    for name, value in vector.items():
        ref.features[name] = value
    # the codec writes the hostname, then one entry per feature in key
    # order: each field byte for byte as protobuf writes it alone
    want = hint_pb2.HintRequest(hostname=hostname).SerializeToString() + \
        b"".join(hint_pb2.HintRequest(features={k: vector[k]})
                 .SerializeToString() for k in sorted(vector))
    assert hs.encode_request(hostname, vector) == want
    if not any(a != b and b.startswith(a) for a in vector for b in vector):
        # protobuf's deterministic order agrees where no key prefixes
        # another (upb puts "f10" before "f1")
        assert want == ref.SerializeToString(deterministic=True)
    # and both decode either's bytes (the JAX client writes map entries in
    # hash order)
    got_host, got = hs.decode_request(ref.SerializeToString())
    assert got_host == hostname
    assert got.keys() == vector.keys()
    for name, value in vector.items():
        assert math.copysign(1, got[name]) == math.copysign(1, value)
        assert got[name] == value
    back = hint_pb2.HintRequest.FromString(hs.encode_request(hostname,
                                                             vector))
    assert back.hostname == hostname and dict(back.features) == vector


@pytest.mark.parametrize("hints", [[], ["one"], ["", "ünï", "x" * 1000],
                                   [f"hint {i}" for i in range(50)]])
def test_response_codec_matches_hint_pb2(hints):
    ref = hint_pb2.HintResponse(hints=hints).SerializeToString()
    assert hs.encode_response(hints) == ref
    assert hs.decode_response(ref) == hints


def test_decoder_skips_unknown_fields_and_rejects_truncation():
    known = hs.encode_request("h", {"a": 1.0})
    # field 9 as a varint, fixed32, and length-delimited, then the rest
    extra = b"\x48\x96\x01" + b"\x4d\x00\x00\x80\x3f" + b"\x4a\x02hi"
    assert hs.decode_request(extra + known) == ("h", {"a": 1.0})
    with pytest.raises(ValueError):
        hs.decode_request(known[:-3])


def _features(cls, vector):
    f = cls()
    for name, value in vector.items():
        f.add(name, value)
    return f


VECTOR = {"gpu0_step_gap_pct": 87.5, "tpu0_step_gap_pct": 87.5,
          "gpu_kernels": 10.0, "cpu_util": 0.95, "num_cores": 8.0,
          "elapsed_time": 2.0}


def test_port_client_against_the_jax_server():
    server, port = jax_hs.serve(0, block=False)
    try:
        got = hs.request_hints(f"127.0.0.1:{port}",
                               _features(Features, VECTOR))
    finally:
        server.stop(0)
    from sofa_tpu.analysis.advice import generate_hints

    want = generate_hints(_features(JaxFeatures, VECTOR), JaxConfig())
    assert got == want and got


def test_jax_client_against_the_port_server():
    server, port = hs.serve(0, block=False)
    try:
        got = jax_hs.request_hints(f"127.0.0.1:{port}",
                                   _features(JaxFeatures, VECTOR))
        empty = jax_hs.request_hints(f"127.0.0.1:{port}", JaxFeatures())
    finally:
        server.stop(0)
    from sofa_tpu_torch.analysis.advice import generate_hints

    assert got == generate_hints(_features(Features, VECTOR), SofaConfig())
    assert got
    assert empty == ["no obvious bottleneck in the submitted feature vector"]


def test_analyze_without_grpc_warns_and_completes(tmp_path, monkeypatch,
                                                  capsys):
    """The card's machine has no grpcio: a configured server is then a
    one-line warning and analyze completes, as for an unreachable one."""
    from sofa_tpu_torch.analyze import sofa_analyze

    monkeypatch.setitem(sys.modules, "grpc", None)
    cfg = SofaConfig(logdir=str(tmp_path / "run"),
                     hint_server="127.0.0.1:50051")
    features = sofa_analyze(cfg, frames={})
    out = capsys.readouterr()
    assert "Complete!!" in out.out
    warned = [ln for ln in out.err.splitlines() if "hint server" in ln]
    assert len(warned) == 1 and "ModuleNotFoundError" in warned[0]
    assert "continuing without remote hints" in warned[0]
    assert features.get("elapsed_time") is not None
