"""The port's HTTP plane held to the JAX package's.

Every case of ``tests/test_http_server.py`` runs on both packages'
``HttpPlane`` (``stt_tpu`` and its copy in ``stt_tpu_torch``), each over its
own ``ApplicationRuntime`` on the fake backend, driven through
``HttpPlane.handle()`` without a socket. Side by side, the two planes give
the same status codes, error codes and payload keys for the same requests;
and the port's own parts are checked: the card section of ``/system``, the
admin load that names a weights path (refused by the port's registry, so
the job fails and the plane keeps serving) and ``/v1/models``' owner.
"""

import importlib
import json
import time

import pytest

PACKAGES = ("stt_tpu", "stt_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _make_runtime(pkg, **over):
    cfg = _mod(pkg, "config.loader").ServerConfig(
        model="tiny", model_backend="fake", device="cpu",
        adaptive_throttle_enabled=False, **over,
    )
    return _mod(pkg, "server.runtime.runtime").ApplicationRuntime(cfg)


@pytest.fixture(scope="module", params=PACKAGES)
def pkg(request):
    return request.param


@pytest.fixture(scope="module")
def runtime(pkg):
    rt = _make_runtime(pkg)
    yield rt
    rt.shutdown(drain_timeout_sec=2.0)


@pytest.fixture(scope="module")
def runtimes():
    """One runtime of each package, for the side-by-side cases."""
    rts = {p: _make_runtime(p) for p in PACKAGES}
    yield rts
    for rt in rts.values():
        rt.shutdown(drain_timeout_sec=2.0)


def make_plane(runtime, *, rps=0.0, burst=0.0, proxies=None, grpc_running=True):
    pkg = type(runtime).__module__.split(".")[0]
    return _mod(pkg, "server.transport.http_server").HttpPlane(
        runtime,
        {"grpc_running": grpc_running},
        http_rate_limit_rps=rps,
        http_rate_limit_burst=burst,
        http_trusted_proxies=proxies,
    )


def call(plane, method, path, *, headers=None, body=b"", peer="1.2.3.4",
         query=None):
    return plane.handle(method, path, query or {}, headers or {}, body, peer)


def _wait_load(plane, headers, model_id, timeout=60.0):
    deadline = time.monotonic() + timeout
    while True:
        status, _, payload = call(plane, "GET", "/admin/load_model_status",
                                  headers=headers, query={"model_id": [model_id]})
        if payload["status"] in ("success", "failed") or time.monotonic() > deadline:
            return status, payload
        time.sleep(0.05)


# -- the cases of tests/test_http_server.py, on both packages ------------------


def test_health_ok(runtime):
    status, _, payload = call(make_plane(runtime), "GET", "/health")
    assert status == 200
    assert payload["status"] == "ok"
    assert payload["models_loaded"] == ["default"]
    assert payload["grpc_running"] is True


def test_health_unhealthy_when_grpc_down(runtime):
    plane = make_plane(runtime, grpc_running=False)
    status, _, payload = call(plane, "GET", "/health")
    assert status == 500
    assert payload["status"] == "error"


def test_health_minimal_mode(runtime, monkeypatch):
    monkeypatch.setenv("STT_PUBLIC_HEALTH", "minimal")
    status, _, payload = call(make_plane(runtime), "GET", "/health")
    assert status == 200
    assert payload == {"status": "ok"}


def test_health_detail_token_mode(runtime, monkeypatch):
    monkeypatch.setenv("STT_HEALTH_DETAIL_MODE", "token")
    monkeypatch.setenv("STT_OBSERVABILITY_TOKEN", "obstok")
    plane = make_plane(runtime)
    status, _, payload = call(plane, "GET", "/health")
    assert status == 200 and payload == {"status": "ok"}
    status, _, payload = call(plane, "GET", "/health",
                              headers={"authorization": "Bearer obstok"})
    assert status == 200
    assert "models_loaded" in payload


def test_metrics_requires_obs_token(runtime, monkeypatch):
    monkeypatch.setenv("STT_OBSERVABILITY_TOKEN", "sekret")
    plane = make_plane(runtime)
    status, _, payload = call(plane, "GET", "/metrics")
    assert status == 401
    assert payload["code"] == "ERR4006"
    status, _, text = call(plane, "GET", "/metrics",
                           headers={"authorization": "Bearer sekret"})
    assert status == 200
    assert "stt_active_sessions" in text


def test_metrics_json(runtime):
    status, _, payload = call(make_plane(runtime), "GET", "/metrics.json")
    assert status == 200
    assert "decode_pending" in payload
    assert "histograms" in payload


def test_system_endpoint(runtime):
    status, _, payload = call(make_plane(runtime), "GET", "/system")
    assert status == 200
    assert payload["process"]["rss_bytes"] > 0
    assert payload["runtime"]["model"]["model_backend"] == "fake"


def test_http_rate_limit(runtime):
    plane = make_plane(runtime, rps=1.0, burst=2.0)
    assert call(plane, "GET", "/health")[0] == 200
    assert call(plane, "GET", "/health")[0] == 200
    status, _, payload = call(plane, "GET", "/health")
    assert status == 429
    assert payload["code"] == "ERR4007"


def test_ip_allowlist(runtime, monkeypatch):
    monkeypatch.setenv("STT_HTTP_ALLOWLIST", "10.0.0.0/8")
    plane = make_plane(runtime)
    status, _, payload = call(plane, "GET", "/health", peer="1.2.3.4")
    assert status == 403 and payload["code"] == "ERR4008"
    assert call(plane, "GET", "/health", peer="10.1.2.3")[0] == 200


def test_forwarded_for_only_from_trusted_proxy(runtime, monkeypatch):
    monkeypatch.setenv("STT_HTTP_ALLOWLIST", "10.0.0.0/8")
    plane = make_plane(runtime, proxies=["192.168.0.1"])
    status, _, _ = call(plane, "GET", "/health", peer="1.2.3.4",
                        headers={"x-forwarded-for": "10.9.9.9"})
    assert status == 403
    status, _, _ = call(plane, "GET", "/health", peer="192.168.0.1",
                        headers={"x-forwarded-for": "10.9.9.9"})
    assert status == 200


def test_admin_disabled_without_env(runtime):
    status, _, payload = call(make_plane(runtime), "GET", "/admin/list_models")
    assert status == 501 and payload["code"] == "ERR4001"


def test_admin_wrong_token(runtime, monkeypatch):
    monkeypatch.setenv("STT_ADMIN_ENABLED", "1")
    monkeypatch.setenv("STT_ADMIN_TOKEN", "right")
    status, _, payload = call(make_plane(runtime), "GET", "/admin/list_models",
                              headers={"authorization": "Bearer wrong"})
    assert status == 401 and payload["code"] == "ERR4004"


def test_admin_load_unload_cycle(runtime, monkeypatch):
    monkeypatch.setenv("STT_ADMIN_ENABLED", "1")
    monkeypatch.setenv("STT_ADMIN_TOKEN", "tok")
    plane = make_plane(runtime)
    headers = {"authorization": "Bearer tok"}
    status, _, payload = call(plane, "GET", "/admin/list_models", headers=headers)
    assert status == 200
    assert [m["model_id"] for m in payload["models"]] == ["default"]

    body = json.dumps({"model_id": "extra", "model_size": "tiny",
                       "backend": "fake", "device": "cpu"}).encode()
    status, _, payload = call(plane, "POST", "/admin/load_model", headers=headers,
                              body=body)
    assert status == 200 and payload["status"] == "loading_started"
    _, payload = _wait_load(plane, headers, "extra", timeout=10)
    assert payload["status"] == "success"
    assert runtime.model_registry.has_model("extra")

    status, _, payload = call(plane, "POST", "/admin/unload_model", headers=headers,
                              query={"model_id": ["extra"]})
    assert status == 200 and payload["status"] == "unloaded"
    assert not runtime.model_registry.has_model("extra")


def test_admin_unknown_profile(runtime, monkeypatch):
    monkeypatch.setenv("STT_ADMIN_ENABLED", "1")
    monkeypatch.setenv("STT_ADMIN_TOKEN", "tok")
    body = json.dumps({"model_id": "x", "profile_id": "nope"}).encode()
    status, _, payload = call(make_plane(runtime), "POST", "/admin/load_model",
                              headers={"authorization": "Bearer tok"}, body=body)
    assert status == 400 and payload["code"] == "ERR4009"


def test_admin_model_path_forbidden(runtime, monkeypatch):
    monkeypatch.setenv("STT_ADMIN_ENABLED", "1")
    monkeypatch.setenv("STT_ADMIN_TOKEN", "tok")
    body = json.dumps({"model_id": "y", "model_path": "/etc/passwd",
                       "backend": "fake"}).encode()
    status, _, payload = call(make_plane(runtime), "POST", "/admin/load_model",
                              headers={"authorization": "Bearer tok"}, body=body)
    assert status == 403 and payload["code"] == "ERR4005"


def test_admin_duplicate_load_conflict(runtime, monkeypatch):
    monkeypatch.setenv("STT_ADMIN_ENABLED", "1")
    monkeypatch.setenv("STT_ADMIN_TOKEN", "tok")
    body = json.dumps({"model_id": "default", "backend": "fake"}).encode()
    status, _, payload = call(make_plane(runtime), "POST", "/admin/load_model",
                              headers={"authorization": "Bearer tok"}, body=body)
    assert status == 409 and payload["code"] == "ERR4002"


def test_flatten_metrics_sanitizes_names(pkg):
    flatten = _mod(pkg, "server.transport.http_server").flatten_metrics
    flat = flatten({"a b": 1, "nested": {"x-y": 2.5}, "skip": None})
    assert flat == {"a_b": 1.0, "nested_x_y": 2.5}


def test_prometheus_text_format(runtime):
    pkg = type(runtime).__module__.split(".")[0]
    text = _mod(pkg, "server.transport.http_server").prometheus_text(
        runtime.metrics.render())
    lines = text.splitlines()
    assert any(line.startswith("# TYPE stt_") for line in lines)
    assert any("histogram" in line for line in lines)
    bucket_lines = [line for line in lines if "decode_latency_sec_bucket" in line]
    assert bucket_lines and 'le="+Inf"' in bucket_lines[-1]


def test_unknown_path_404(runtime):
    status, _, _ = call(make_plane(runtime), "GET", "/nope")
    assert status == 404


# -- side by side: the same requests give the same answers ---------------------


def _shape(payload):
    """Keys (recursively, for dicts) of a JSON payload: what two planes of
    different processes can share, where values (times, memory) differ."""
    if isinstance(payload, dict):
        return {k: _shape(v) for k, v in payload.items()}
    return type(payload).__name__


@pytest.mark.parametrize("path", ["/health", "/metrics.json"])
def test_payload_keys_match_the_jax_plane(runtimes, path):
    got = {p: call(make_plane(rt), "GET", path) for p, rt in runtimes.items()}
    (js, jc, jp), (ts, tc, tp) = got["stt_tpu"], got["stt_tpu_torch"]
    assert (ts, tc) == (js, jc) == (200, "application/json")
    if path == "/health":
        assert _shape(tp) == _shape(jp)
    else:
        # the histograms' names and the flat counters' names
        assert set(tp) == set(jp)
        assert set(tp["histograms"]) == set(jp["histograms"])


def test_metrics_text_names_match_the_jax_plane(runtimes):
    def names(rt):
        _, _, text = call(make_plane(rt), "GET", "/metrics")
        return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
                if line and not line.startswith("#")}

    assert names(runtimes["stt_tpu_torch"]) == names(runtimes["stt_tpu"])


ADMIN_PROBES = [
    ("GET", "/admin/list_models", None, "wrong", {}),
    ("GET", "/admin/list_models", None, "tok", {}),
    ("POST", "/admin/load_model", {"model_id": "x", "profile_id": "nope"}, "tok", {}),
    ("POST", "/admin/load_model", {"model_id": "y", "model_path": "/etc/passwd",
                                   "backend": "fake"}, "tok", {}),
    ("POST", "/admin/load_model", {"model_id": "default", "backend": "fake"}, "tok", {}),
    ("POST", "/admin/load_model", {}, "tok", {}),
    ("POST", "/admin/unload_model", None, "tok", {"model_id": ["absent"]}),
    ("GET", "/admin/load_model_status", None, "tok", {"model_id": ["absent"]}),
    ("GET", "/v1/models", None, "tok", {}),
    ("GET", "/nope", None, "tok", {}),
]


@pytest.mark.parametrize("admin", [False, True], ids=["admin_off", "admin_on"])
def test_admin_codes_match_the_jax_plane(runtimes, monkeypatch, admin):
    if admin:
        monkeypatch.setenv("STT_ADMIN_ENABLED", "1")
        monkeypatch.setenv("STT_ADMIN_TOKEN", "tok")
    for method, path, body, token, query in ADMIN_PROBES:
        got = {}
        for p, rt in runtimes.items():
            status, ctype, payload = call(
                make_plane(rt), method, path, query=query,
                headers={"authorization": f"Bearer {token}"},
                body=b"" if body is None else json.dumps(body).encode())
            code = payload.get("code") if isinstance(payload, dict) else None
            got[p] = (status, ctype, code)
        assert got["stt_tpu_torch"] == got["stt_tpu"], (method, path, body)


def test_v1_models_names_the_port(runtimes):
    _, _, jp = call(make_plane(runtimes["stt_tpu"]), "GET", "/v1/models")
    _, _, tp = call(make_plane(runtimes["stt_tpu_torch"]), "GET", "/v1/models")
    assert [m["id"] for m in tp["data"]] == [m["id"] for m in jp["data"]]
    assert {m["owned_by"] for m in tp["data"]} == {"stt_tpu_torch"}
    assert [{k: v for k, v in m.items() if k != "owned_by"} for m in tp["data"]] == [
        {k: v for k, v in m.items() if k != "owned_by"} for m in jp["data"]]


# -- the port's own parts ------------------------------------------------------


def test_system_card_section_switch(monkeypatch):
    """``STT_ENABLE_TPU_METRICS`` switches the card section on under the
    JAX key ``"tpu"``; with no card it reports none."""
    sm = _mod("stt_tpu_torch", "server.runtime.system_metrics")
    monkeypatch.delenv("STT_ENABLE_TPU_METRICS", raising=False)
    assert "tpu" not in sm.collect_system_metrics()
    monkeypatch.setenv("STT_ENABLE_TPU_METRICS", "1")
    payload = sm.collect_system_metrics()
    assert payload["tpu"] == {"device_count": 0, "platform": "none", "devices": []}
    assert set(payload) == {"process", "system", "tpu"}


def test_system_card_section_on_a_mocked_card(monkeypatch):
    """The card section's keys are the ones the dashboard reads (``kind``,
    ``id``, ``bytes_in_use``, ``bytes_limit``), with platform ``gpu``."""
    import types

    import torch

    sm = _mod("stt_tpu_torch", "server.runtime.system_metrics")
    monkeypatch.setenv("STT_ENABLE_TPU_METRICS", "on")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card{i}")
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 100 + i)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(total_memory=1000))
    tpu = sm.collect_system_metrics()["tpu"]
    assert tpu == {"device_count": 2, "platform": "gpu", "devices": [
        {"id": 0, "kind": "card0", "bytes_in_use": 100, "bytes_limit": 1000},
        {"id": 1, "kind": "card1", "bytes_in_use": 101, "bytes_limit": 1000},
    ]}


def test_admin_weights_path_fails_the_job_and_the_plane_serves(monkeypatch):
    """A weights path that passes the allowlist reaches the port's engine,
    whose loader finds no checkpoint there: the background job reports
    ``failed`` with the missing file, and the plane keeps serving."""
    monkeypatch.setenv("STT_ADMIN_ENABLED", "1")
    monkeypatch.setenv("STT_ADMIN_TOKEN", "tok")
    monkeypatch.setenv("STT_ADMIN_ALLOW_MODEL_PATH", "1")
    monkeypatch.setenv("STT_ADMIN_MODEL_PATH_ALLOWLIST", "/models/")
    rt = _make_runtime("stt_tpu_torch")
    try:
        plane = make_plane(rt)
        headers = {"authorization": "Bearer tok"}
        body = json.dumps({"model_id": "ckpt", "backend": "torch_whisper",
                           "model_size": "test", "device": "cpu",
                           "compute_type": "float32",
                           "weights_path": "/models/small"}).encode()
        status, _, payload = call(plane, "POST", "/admin/load_model", headers=headers,
                                  body=body)
        assert status == 200 and payload["status"] == "loading_started"
        _, payload = _wait_load(plane, headers, "ckpt")
        assert payload["status"] == "failed"
        assert "/models/small/config.json" in payload["error"]
        assert not rt.model_registry.has_model("ckpt")
        # outside the allowlist it is refused before any load
        body = json.dumps({"model_id": "c2", "model_path": "/etc/x"}).encode()
        status, _, payload = call(plane, "POST", "/admin/load_model", headers=headers,
                                  body=body)
        assert status == 403 and payload["code"] == "ERR4005"
        assert call(plane, "GET", "/health")[0] == 200
    finally:
        rt.shutdown(drain_timeout_sec=2.0)
