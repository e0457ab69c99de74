"""Platform plumbing shared by the CLI, bench, chip_smoke and tools.

  - `pin_requested_platform` honours an explicit JAX_PLATFORMS request;
  - first-compile latency dominates short runs (the raycast simulator,
    featurizer, and registration programs take minutes to build) —
    `enable_compilation_cache` turns on JAX's persistent cache so repeat
    invocations skip compilation;
  - `bench_metadata` stamps every benchmark record with the device it ran
    on, and on a GPU with the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pin_requested_platform() -> None:
    """Apply an explicit JAX_PLATFORMS request to the JAX config (a value
    set in the config before this call would otherwise win)."""
    import jax

    req = os.environ.get("JAX_PLATFORMS", "")
    if req:
        jax.config.update("jax_platforms", req)


def _host_fingerprint() -> str:
    """Short fingerprint of the host CPU feature set. XLA:CPU persists
    AOT-compiled executables whose cache key does NOT include the precise
    CPU feature flags; loading an entry produced on a host with a
    different avx512/amx set can SIGILL/segfault (cpu_aot_loader warns
    'could lead to execution errors such as SIGILL' — observed as a
    deterministic segfault in compilation_cache.get_executable_and_time
    when a cache dir was reused across machines). Scoping the cache dir
    by this fingerprint makes cross-machine reuse impossible."""
    import hashlib
    import platform as _platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    raw = f"{_platform.machine()}|{flags}"
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `<repo>/.jax_cache/<host
    fingerprint>` — a fixed path inside the checkout (the path is part of
    the cache key, so it must not move between runs)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(REPO_ROOT, ".jax_cache", _host_fingerprint())


def enable_compilation_cache() -> str:
    """Enable the persistent compilation cache (idempotent) in
    `compilation_cache_dir()` and return that directory."""
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache everything regardless of compile time / program size
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def parse_gpu_card(line: str) -> dict:
    """One line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` -> {"name", "power_limit_w"}."""
    name, _, limit = line.strip().rpartition(",")
    watts = limit.strip().split()[0] if limit.strip() else ""
    try:
        power = float(watts)
    except ValueError:
        power = None
    return {"name": name.strip(), "power_limit_w": power}


def gpu_card_line() -> str:
    """The first card's `name, power.limit` line as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def bench_metadata() -> dict:
    """Machine/provenance stamp for every bench JSON: the device, the JAX
    version, the git SHA of the working tree at run time, and on a GPU the
    card's name and power limit (a card set below its maximum limit runs
    slower under load)."""
    import platform as _plat

    import jax

    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5, cwd=REPO_ROOT,
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        sha = None
    dev = jax.devices()[0]
    meta = {
        "platform": dev.platform,
        "device": getattr(dev, "device_kind", str(dev)),
        "n_devices": jax.device_count(),
        "jax_version": jax.__version__,
        "matmul_precision": jax.config.jax_default_matmul_precision,
        "host": _plat.node() or "unknown",
        "git_sha": sha,
    }
    if dev.platform == "gpu":
        meta["gpu"] = parse_gpu_card(gpu_card_line())
    return meta
