"""Device diagnostics: enumerate adapters and probe backends.

Twin of ``python/tools/device_diagnostics.py`` on the port: the same JSON
shape ({"adapters": [...], "probes": [...]}) and the same exit policy --
success if any probe is ok, or all are unsupported.

    python -m vulkan_forge_torch.tools.device_diagnostics [--backends CUDA CPU]
"""
from __future__ import annotations

import argparse
import json
import os

from vulkan_forge_torch import device_probe, enumerate_adapters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", nargs="*", default=None,
                    help="Backends to probe (default: the --device's, then CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device probed first (default: cuda)")
    ap.add_argument("--json", default="diag_out/device_diagnostics_torch.json")
    args = ap.parse_args(argv)

    default = [args.device.upper()] + (["CPU"] if args.device != "cpu" else [])
    backends = [b.upper() for b in (args.backends or default)]

    adapters = enumerate_adapters()
    probes = [device_probe(b) for b in backends]

    report = {"adapters": adapters, "probes": probes}
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    with open(args.json, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))

    statuses = [p.get("status") for p in probes]
    any_ok = any(s == "ok" for s in statuses)
    all_unsupported = all(s == "unsupported" for s in statuses)
    return 0 if (any_ok or all_unsupported) else 1


if __name__ == "__main__":
    raise SystemExit(main())
