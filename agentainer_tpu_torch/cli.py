"""``agentainer-torch`` CLI — the operator's verbs against the port's daemon.

Reference: ``agentainer_tpu/cli.py``, with the same verbs, options,
output and exit codes: server, deploy (``--model-dir``, ``-f``), start,
stop, restart, pause, resume, remove, list, logs, invoke, requests,
requeue, health, metrics, models, slice, backup {create,list,restore,
delete,export}, faults, audit, logs-server. Every verb but ``server`` is
a thin HTTP client of the management API with a bearer token; a failed
envelope prints ``error: <message>`` and exits 1. ``server`` runs the
port's daemon (``daemon.py``).

What differs: HTTP goes through the standard library (``urllib.request``)
where the reference uses ``requests``, which the machine with the card
lacks; ``backup export`` writes the archive to the client's disk in 1 MiB
chunks as they arrive, and the follow verbs print lines as they come.
Nothing here imports torch, and ``-f`` reads YAML only where PyYAML is
installed (a JSON deployment file reads anywhere, ``manager/
deployconfig.py``).

Usage:  python -m agentainer_tpu_torch.cli <command> [...]   (or the
``agentainer-torch`` console script once installed).
"""

from __future__ import annotations

import argparse
import codecs
import json
import os
import sys
import urllib.error
import urllib.request

from .config import load_config

_CHUNK = 1 << 20


def _base(args) -> str:
    return args.server.rstrip("/")


def _headers(args) -> dict:
    return {"Authorization": f"Bearer {args.token}"}


def _open(method: str, url: str, headers: dict | None = None, data: bytes | None = None,
          timeout: float | None = 60):
    """The response to one request, an error status included (read it like
    any other); a failed connection prints ``error:`` and exits 1."""
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        return e
    except (urllib.error.URLError, OSError) as e:
        print(f"error: {getattr(e, 'reason', e)}", file=sys.stderr)
        sys.exit(1)


def _call(args, method: str, path: str, body: dict | None = None) -> dict:
    headers = _headers(args)
    data = None
    if body is not None:
        headers["Content-Type"] = "application/json"
        data = json.dumps(body).encode()
    with _open(method, _base(args) + path, headers, data) as resp:
        raw = resp.read()
        status = resp.status
    try:
        doc = json.loads(raw)
    except ValueError:
        print(f"error: non-JSON response ({status})", file=sys.stderr)
        sys.exit(1)
    if not doc.get("success", False):
        print(f"error: {doc.get('message', status)}", file=sys.stderr)
        sys.exit(1)
    return doc


def _print(data) -> None:
    print(json.dumps(data, indent=2, default=str))


def _parse_env(pairs: list[str]) -> dict[str, str]:
    env = {}
    for pair in pairs or []:
        key, sep, val = pair.partition("=")
        if not sep:
            raise SystemExit(f"--env expects KEY=VALUE, got {pair!r}")
        env[key] = val
    return env


# -- commands -------------------------------------------------------------
def cmd_server(args) -> None:
    from .daemon import main as run_daemon

    cfg = load_config(args.config)
    if args.port:
        cfg.server.port = args.port
    run_daemon(cfg)


def cmd_deploy(args) -> None:
    if args.file:
        from .manager.deployconfig import fan_out, load_deployment

        config = load_deployment(args.file)
        for spec in config.agents:
            for name, s in fan_out(spec):
                doc = _call(
                    args,
                    "POST",
                    "/agents",
                    {
                        "name": name,
                        "model": s.model.to_dict(),
                        "env": s.env,
                        "resources": s.resources.to_dict(),
                        "auto_restart": s.auto_restart,
                        "health_check": s.health_check.to_dict() if s.health_check else None,
                        "replicas": s.engine_replicas,
                    },
                )
                agent = doc["data"]
                print(f"deployed {name}: {agent['id']}")
                if args.start:
                    _call(args, "POST", f"/agents/{agent['id']}/start")
                    print(f"started {agent['id']}")
        return
    model: object = args.model
    if args.model_dir:
        # deploy from a directory: validate + register the checkpoint as a
        # dedup-named artifact (its build log printed), then deploy an llm
        # agent serving it
        doc = _call(args, "POST", "/artifacts", {"path": args.model_dir, "name": args.name or ""})
        art = doc["data"]
        for line in art.get("build_log", []):
            print(f"  {line}")
        print(f"built artifact {art['name']!r}")
        model = {"engine": "llm", "artifact": art["name"]}
    # each engine-option flag pins this agent's option through the same
    # channel a deployment file uses (model.options); a bare
    # "engine:config" string becomes the dict form first
    option_overrides: dict[str, object] = {}
    if args.no_speculative:
        option_overrides["speculative"] = False
    if args.paged_kv or args.no_paged_kv:
        option_overrides["paged_kv"] = bool(args.paged_kv)
    if args.no_adaptive_decode:
        option_overrides["adaptive_decode"] = False
    if args.no_prefix_cache:
        option_overrides["prefix_cache"] = False
    if args.no_deadlines:
        option_overrides["deadlines"] = False
    for flag in ("fused_decode", "inloop_spec", "approx_topk", "kv_tiering", "streaming"):
        if getattr(args, flag) or getattr(args, f"no_{flag}"):
            option_overrides[flag] = bool(getattr(args, flag))
    if option_overrides:
        if isinstance(model, str):
            engine, _, config = model.partition(":")
            model = {"engine": engine or "echo", "config": config}
        model.setdefault("options", {}).update(option_overrides)
    body = {
        "name": args.name,
        "model": model,
        "env": _parse_env(args.env),
        "resources": {"chips": args.chips, "hbm_bytes": args.hbm_bytes},
        "auto_restart": args.auto_restart,
    }
    if args.replicas:
        body["replicas"] = args.replicas
    if args.health_endpoint:
        body["health_check"] = {
            "endpoint": args.health_endpoint,
            "interval_s": args.health_interval,
            "timeout_s": args.health_timeout,
            "retries": args.health_retries,
        }
    doc = _call(args, "POST", "/agents", body)
    agent = doc["data"]
    print(f"deployed {agent['name']}: {agent['id']}")
    if args.start:
        _call(args, "POST", f"/agents/{agent['id']}/start")
        print(f"started {agent['id']}")


def _lifecycle(op: str):
    def cmd(args) -> None:
        doc = _call(args, "POST", f"/agents/{args.agent_id}/{op}")
        agent = doc["data"]
        print(f"{op}: {agent['id']} is {agent['status']}")

    return cmd


def cmd_remove(args) -> None:
    _call(args, "DELETE", f"/agents/{args.agent_id}")
    print(f"removed {args.agent_id}")


def cmd_list(args) -> None:
    doc = _call(args, "GET", "/agents")
    rows = doc["data"]
    if args.json:
        _print(rows)
        return
    fmt = "{:<28} {:<16} {:<9} {:<12} {}"
    print(fmt.format("ID", "NAME", "STATUS", "MODEL", "CHIPS"))
    for a in rows:
        chips = (a.get("placement") or {}).get("chips", [])
        model = a["model"]["engine"] + (f":{a['model']['config']}" if a["model"]["config"] else "")
        print(fmt.format(a["id"], a["name"][:16], a["status"], model[:12], chips))


def cmd_logs(args) -> None:
    if args.follow:
        # stream until interrupted (docker logs -f parity)
        url = _base(args) + f"/agents/{args.agent_id}/logs?tail={args.tail}&follow=1"
        with _open("GET", url, _headers(args), timeout=None) as resp:
            if resp.status != 200:
                print(f"error: {resp.status} {resp.read()[:200].decode('utf-8', 'replace')}", file=sys.stderr)
                sys.exit(1)
            # a multibyte character may straddle two reads
            text = codecs.getincrementaldecoder("utf-8")("replace")
            try:
                while chunk := resp.read1(1024):
                    sys.stdout.write(text.decode(chunk))
                    sys.stdout.flush()
            except KeyboardInterrupt:
                pass
        return
    doc = _call(args, "GET", f"/agents/{args.agent_id}/logs?tail={args.tail}")
    for line in doc["data"]["logs"]:
        print(line)


def cmd_invoke(args) -> None:
    """A request through the proxy (the reference's ``invoke``)."""
    url = f"{_base(args)}/agent/{args.agent_id}{args.path}"
    body = args.data.encode() if args.data else None
    with _open(args.method, url, data=body, timeout=120) as resp:
        print(f"HTTP {resp.status}")
        print(resp.read().decode("utf-8", "replace"))


def cmd_requests(args) -> None:
    import time as _time

    doc = _call(args, "GET", f"/agents/{args.agent_id}/requests?status={args.status}")
    data = doc["data"]
    print(f"stats: {data['stats']}")
    for r in data["requests"]:
        line = f"  {r['id']}  {r['method']} {r['path']}  {r['status']}  retries={r['retry_count']}"
        if r.get("deadline_at"):
            remaining = r["deadline_at"] - _time.time()
            line += f"  deadline={'+' if remaining > 0 else ''}{remaining:.1f}s"
        if r.get("error"):
            line += f"  error={r['error']}"
        print(line)


def cmd_requeue(args) -> None:
    """Put a dead-lettered (failed/expired) request back on the pending
    queue with retries reset — operator recovery after a transient outage."""
    doc = _call(args, "POST", f"/agents/{args.agent_id}/requests/{args.request_id}/requeue")
    r = doc["data"]
    print(f"requeued {r['id']} ({r['method']} {r['path']}); replay kicked")


def cmd_health(args) -> None:
    if args.agent_id:
        _print(_call(args, "GET", f"/agents/{args.agent_id}/health")["data"])
    else:
        _print(_call(args, "GET", "/health")["data"])


def cmd_metrics(args) -> None:
    if args.agent_id:
        path = f"/agents/{args.agent_id}/metrics"
        if args.history:
            path += "/history"
        _print(_call(args, "GET", path)["data"])
    else:
        _print(_call(args, "GET", "/metrics")["data"])


def cmd_models(args) -> None:
    doc = _call(args, "GET", "/artifacts")
    rows = doc["data"]
    if not rows:
        print("no artifacts registered (deploy --model-dir ./checkpoint to add one)")
        return
    for a in rows:
        params = f"{a['n_params'] / 1e6:.1f}M" if a.get("n_params") else "?"
        print(f"{a['name']:24s} {a['layout']:6s} {params:>10s}  {a['path']}")


def cmd_slice(args) -> None:
    _print(_call(args, "GET", "/slice")["data"])


def cmd_backup(args) -> None:
    if args.backup_cmd == "create":
        doc = _call(args, "POST", "/backups", {"name": args.name, "description": args.description})
        print(f"created {doc['data']['id']} ({doc['data']['agents']} agents)")
    elif args.backup_cmd == "list":
        _print(_call(args, "GET", "/backups")["data"])
    elif args.backup_cmd == "restore":
        doc = _call(args, "POST", f"/backups/{args.backup_id}/restore")
        print(f"restored {len(doc['data'])} agents")
    elif args.backup_cmd == "delete":
        _call(args, "DELETE", f"/backups/{args.backup_id}")
        print(f"deleted {args.backup_id}")
    elif args.backup_cmd == "export":
        # the server streams the tar.gz; the archive lands on THIS machine,
        # written as it arrives (it carries KV snapshots: it can be large)
        url = _base(args) + f"/backups/{args.backup_id}/export"
        with _open("POST", url, _headers(args), timeout=120) as resp:
            if resp.status != 200 or resp.headers.get("Content-Type", "").startswith("application/json"):
                try:
                    msg = json.loads(resp.read()).get("message", resp.status)
                except ValueError:
                    msg = resp.status
                print(f"error: {msg}", file=sys.stderr)
                sys.exit(1)
            out = args.output or f"{args.backup_id}.tar.gz"
            with open(out, "wb") as f:
                while chunk := resp.read(_CHUNK):
                    f.write(chunk)
        print(f"exported to {out}")


def cmd_faults(args) -> None:
    """Inspect/arm/disarm the daemon's fault-injection plane (failpoints).

    Examples:
        agentainer-torch faults                       # list active failpoints
        agentainer-torch faults --arm "store.get:error=ConnectionError,count=5"
        agentainer-torch faults --disarm store.get
        agentainer-torch faults --clear               # disarm everything
    """
    body = {}
    if args.clear:
        body["disarm_all"] = True
    if args.disarm:
        body["disarm"] = args.disarm
    if args.arm:
        body["arm"] = ";".join(args.arm)
    if body:
        doc = _call(args, "POST", "/internal/faults", body)
        data = doc["data"]
        for name in data["armed"]:
            print(f"armed {name}")
        for name in data["disarmed"]:
            print(f"disarmed {name}")
        active = data["active"]
    else:
        active = _call(args, "GET", "/internal/faults")["data"]["active"]
    if not active:
        print("no failpoints armed")
        return
    fmt = "{:<28} {:<20} {:>9} {:>6} {:>7} {:>7} {:>10}"
    print(fmt.format("NAME", "ERROR", "DELAY_MS", "P", "COUNT", "FIRED", "EVALUATED"))
    for fp in active:
        print(
            fmt.format(
                fp["name"],
                fp["error"],
                fp["delay_ms"],
                fp["probability"],
                fp["count"],
                fp["fired"],
                fp["evaluated"],
            )
        )


def cmd_audit(args) -> None:
    path = f"/audit?limit={args.limit}"
    if args.action:
        path += f"&action={args.action}"
    for e in _call(args, "GET", path)["data"]:
        print(f"{e['ts']:.0f}  {e['user']:<12} {e['action']:<16} {e['resource']:<32} {e['result']}")


def _log_line(e: dict) -> str:
    return f"{e['ts']:.0f}  {e['level']:<5} {e['component']:<12} {e['message']}"


def cmd_atlogs(args) -> None:
    if args.follow:
        # JSON lines from the logs:stream channel, printed as they come
        url = _base(args) + f"/logs?follow=1&limit={args.limit}"
        if args.component:
            url += f"&component={args.component}"
        with _open("GET", url, _headers(args), timeout=None) as resp:
            for raw in resp:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    print(_log_line(json.loads(raw)), flush=True)
                except (ValueError, KeyError):
                    print(raw.decode(errors="replace"), flush=True)
        return
    path = f"/logs?limit={args.limit}"
    if args.component:
        path += f"&component={args.component}"
    for e in _call(args, "GET", path)["data"]:
        print(_log_line(e))


def _pair(s, flag: str, no_flag: str, on: str, off: str) -> None:
    """``--flag`` and ``--no-flag``, mutually exclusive. Both are spelled
    out at the call, where the feature-flag rule (ATP006) reads them."""
    group = s.add_mutually_exclusive_group()
    group.add_argument(flag, action="store_true", help=on)
    group.add_argument(no_flag, action="store_true", help=off)


def build_parser() -> argparse.ArgumentParser:
    cfg = load_config()
    p = argparse.ArgumentParser(prog="agentainer-torch", description=__doc__)
    p.add_argument(
        "--server",
        default=os.environ.get("ATPU_SERVER_URL", f"http://127.0.0.1:{cfg.server.port}"),
        help="management API base URL",
    )
    p.add_argument("--token", default=cfg.auth_token, help="bearer token")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server", help="run the control-plane daemon")
    s.add_argument("--config", default=None)
    s.add_argument("--port", type=int, default=None)
    s.set_defaults(fn=cmd_server)

    s = sub.add_parser("deploy", help="deploy an agent (or -f deployment.yaml)")
    s.add_argument("--name")
    s.add_argument("--model", default="echo", help='engine[:config], e.g. "llm:llama3-8b"')
    s.add_argument(
        "--model-dir",
        default="",
        help="deploy from a local HF checkpoint directory (config.json + "
        "safetensors): validates it from the headers, registers a "
        "dedup-named artifact, and serves it with the llm engine",
    )
    s.add_argument("--env", action="append", default=[], metavar="KEY=VALUE")
    s.add_argument(
        "--replicas",
        type=int,
        default=0,
        help="engine replicas for this agent (fleet: health-aware routing, "
        "mid-decode failover, token-identical session resume on a "
        "survivor); 0 = the daemon's fleet.replicas default",
    )
    s.add_argument("--chips", type=int, default=1, help="GPUs")
    s.add_argument("--hbm-bytes", type=int, default=8 * 1024**3, help="card memory budget")
    s.add_argument("--auto-restart", action="store_true")
    s.add_argument(
        "--no-speculative",
        action="store_true",
        help="disable self-speculative decoding for this agent's engine "
        "(options.speculative: false in a deployment file)",
    )
    _pair(
        s, "--paged-kv", "--no-paged-kv",
        "serve this agent's engine from the paged KV arena (options.paged_kv: true)",
        "pin this agent's engine to the dense KV arena even when the fleet "
        "default features.paged_kv is on",
    )
    s.add_argument(
        "--no-adaptive-decode",
        action="store_true",
        help="pin this agent's engine to the fixed-cadence decode loop "
        "(options.adaptive_decode: false)",
    )
    s.add_argument(
        "--no-prefix-cache",
        action="store_true",
        help="disable the cross-session prefix KV arena for this agent's "
        "engine (options.prefix_cache: false)",
    )
    s.add_argument(
        "--no-deadlines",
        action="store_true",
        help="disable engine-side deadline enforcement for this agent "
        "(options.deadlines: false)",
    )
    _pair(
        s, "--fused-decode", "--no-fused-decode",
        "run this agent's engine with the fused on-device decode loop (one "
        "CUDA graph with a WHILE node; options.fused_decode: true)",
        "pin this agent's engine to the per-chunk decode dispatch even when "
        "the fleet default features.fused_decode is on",
    )
    _pair(
        s, "--inloop-spec", "--no-inloop-spec",
        "draft and verify inside the fused decode loop (options.inloop_spec: true)",
        "pin this agent's engine to the host-side prompt-lookup drafter even "
        "when the fleet default features.inloop_spec is on",
    )
    _pair(
        s, "--approx-topk", "--no-approx-topk",
        "sample through a top-k segment instead of the full-vocab sort (not "
        "bit-exact for sampled lanes; options.approx_topk: true)",
        "pin this agent's engine to the exact sampler even when the fleet "
        "default features.approx_topk is on",
    )
    _pair(
        s, "--kv-tiering", "--no-kv-tiering",
        "park idle sessions' KV in pinned host memory and the store, promote "
        "them on their next turn (options.kv_tiering: true)",
        "pin this agent's engine to the resident-only KV arena even when the "
        "fleet default features.kv_tiering is on",
    )
    _pair(
        s, "--streaming", "--no-streaming",
        "answer stream=true chat bodies with SSE token events "
        "(options.streaming: true)",
        "pin this agent's engine to buffered responses even when the fleet "
        "default features.streaming is on",
    )
    s.add_argument("--health-endpoint", default="")
    s.add_argument("--health-interval", type=float, default=30.0)
    s.add_argument("--health-timeout", type=float, default=5.0)
    s.add_argument("--health-retries", type=int, default=3)
    s.add_argument("--start", action="store_true", help="start right after deploy")
    s.add_argument("-f", "--file", help="AgentDeployment file (YAML, or JSON without PyYAML)")
    s.set_defaults(fn=cmd_deploy)

    for op in ("start", "stop", "restart", "pause", "resume"):
        s = sub.add_parser(op, help=f"{op} an agent")
        s.add_argument("agent_id")
        s.set_defaults(fn=_lifecycle(op))

    s = sub.add_parser("remove", help="remove an agent and all its state")
    s.add_argument("agent_id")
    s.set_defaults(fn=cmd_remove)

    s = sub.add_parser("list", help="list agents")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_list)

    s = sub.add_parser("logs", help="engine logs")
    s.add_argument("agent_id")
    s.add_argument("--tail", type=int, default=100)
    s.add_argument("-f", "--follow", action="store_true", help="stream new lines")
    s.set_defaults(fn=cmd_logs)

    s = sub.add_parser("invoke", help="send a request through the proxy")
    s.add_argument("agent_id")
    s.add_argument("path", help="e.g. /chat")
    s.add_argument("--method", default="POST")
    s.add_argument("--data", default="")
    s.set_defaults(fn=cmd_invoke)

    s = sub.add_parser("requests", help="journaled requests for an agent")
    s.add_argument("agent_id")
    s.add_argument("--status", default="pending", help="pending|processing|completed|failed|expired")
    s.set_defaults(fn=cmd_requests)

    s = sub.add_parser("requeue", help="reset a dead-lettered (failed/expired) request back onto pending")
    s.add_argument("agent_id")
    s.add_argument("request_id")
    s.set_defaults(fn=cmd_requeue)

    s = sub.add_parser("health", help="server or agent health")
    s.add_argument("agent_id", nargs="?", default="")
    s.set_defaults(fn=cmd_health)

    s = sub.add_parser("metrics", help="metrics (all agents or one)")
    s.add_argument("agent_id", nargs="?", default="")
    s.add_argument("--history", action="store_true")
    s.set_defaults(fn=cmd_metrics)

    s = sub.add_parser("models", help="registered model artifacts")
    s.set_defaults(fn=cmd_models)

    s = sub.add_parser("slice", help="GPU topology + placements")
    s.set_defaults(fn=cmd_slice)

    s = sub.add_parser("backup", help="backup management")
    bs = s.add_subparsers(dest="backup_cmd", required=True)
    b = bs.add_parser("create")
    b.add_argument("--name", default="")
    b.add_argument("--description", default="")
    for name in ("restore", "delete"):
        b = bs.add_parser(name)
        b.add_argument("backup_id")
    b = bs.add_parser("export")
    b.add_argument("backup_id")
    b.add_argument("-o", "--output", default="")
    bs.add_parser("list")
    s.set_defaults(fn=cmd_backup)

    s = sub.add_parser("faults", help="fault-injection plane: list/arm/disarm failpoints on the daemon")
    s.add_argument(
        "--arm",
        action="append",
        default=[],
        metavar="SPEC",
        help='failpoint spec, e.g. "store.get:error=ConnectionError,'
        'probability=0.5,seed=7,count=10" (repeatable)',
    )
    s.add_argument("--disarm", action="append", default=[], metavar="NAME", help="disarm one failpoint")
    s.add_argument("--clear", action="store_true", help="disarm every failpoint")
    s.set_defaults(fn=cmd_faults)

    s = sub.add_parser("audit", help="audit trail")
    s.add_argument("--limit", type=int, default=50)
    s.add_argument("--action", default="")
    s.set_defaults(fn=cmd_audit)

    s = sub.add_parser("logs-server", help="control-plane structured logs")
    s.add_argument("--limit", type=int, default=50)
    s.add_argument("--component", default="")
    s.add_argument("-f", "--follow", action="store_true", help="stream live entries")
    s.set_defaults(fn=cmd_atlogs)

    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except BrokenPipeError:
        # stdout piped into head/less that exited: not an error
        try:
            sys.stdout.close()
        except Exception:
            pass
        sys.exit(0)


if __name__ == "__main__":
    main()
