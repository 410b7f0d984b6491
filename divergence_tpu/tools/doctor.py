"""Environment diagnostics: devices, card, caches, native runtime.

``divergence_tpu doctor`` prints one JSON report — run it before filing
a performance or correctness report.  Everything runs in this process:
a second JAX process on the same GPU would fail for want of device
memory, because each JAX process reserves most of the card when it
starts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi``'s card name and power limit (one line per card),
    or None where the tool is missing or fails."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() if r.returncode == 0 and r.stdout.strip() else None


def run_doctor() -> dict:
    report: dict = {
        "python": sys.version.split()[0],
        "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS"),
        "XLA_FLAGS": os.environ.get("XLA_FLAGS"),
    }

    import jax

    import divergence_tpu  # noqa: F401  (x64 + compile-cache setup)

    report["jax"] = jax.__version__
    try:
        ds = jax.devices()
        report["devices"] = {
            "platform": ds[0].platform,
            "kind": ds[0].device_kind,
            "count": len(ds),
        }
    except RuntimeError as e:
        report["devices"] = {"error": str(e)}
    report["gpu"] = gpu_name_and_power_limit()

    cache = jax.config.jax_compilation_cache_dir
    try:
        n = len(os.listdir(cache)) if cache and os.path.isdir(cache) else 0
        report["compile_cache"] = {"dir": cache, "entries": n}
    except OSError as e:
        report["compile_cache"] = {"dir": cache, "error": str(e)}

    try:
        from divergence_tpu.native import native_available

        report["native_parser"] = bool(native_available())
    except (ImportError, OSError) as e:
        report["native_parser"] = f"error: {e}"
    return report


def main(args=None) -> None:
    print(json.dumps(run_doctor(), indent=2))


if __name__ == "__main__":
    main()
