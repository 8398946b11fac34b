"""Umbrella CLI: one front door for the port's operational tools.

    PYTHONPATH=src python -m repro_torch.tina serve --pipeline spectrogram ...
    PYTHONPATH=src python -m repro_torch.tina tune  --pipeline pfb_power ...
    PYTHONPATH=src python -m repro_torch.tina trace out.json --require ...

Each subcommand delegates to the module that owns it (``python -m
repro_torch.launch.dsp_serve``, ``python -m repro_torch.graph.autotune``,
``python -m repro_torch.obs.trace`` keep working); this package is
routing, not logic.  Flags after the subcommand are passed through
verbatim.  Every route names a module of this package, never one of the
JAX package.
"""
from __future__ import annotations

import importlib

COMMANDS = {
    "serve": ("repro_torch.launch.dsp_serve",
              "batched / continuous / multi-tenant pipeline serving"),
    "tune": ("repro_torch.graph.autotune",
             "measure-and-persist autotuning for a built-in pipeline"),
    "trace": ("repro_torch.obs.trace",
              "validate a chrome-trace JSON (nesting, required spans)"),
}


def _usage() -> str:
    lines = ["usage: python -m repro_torch.tina {%s} [args...]"
             % "|".join(COMMANDS)]
    for name, (mod, desc) in COMMANDS.items():
        lines.append(f"  {name:<7}{desc}  (= python -m {mod})")
    lines.append("run a subcommand with -h for its own flags")
    return "\n".join(lines)


def main(argv=None) -> int:
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        raise SystemExit(f"repro_torch.tina: unknown command {cmd!r}\n"
                         + _usage())
    rc = importlib.import_module(COMMANDS[cmd][0]).main(rest)
    # a subcommand returns an exit code, None, or (serve) a summary dict
    return rc if isinstance(rc, int) else 0


__all__ = ["COMMANDS", "main"]
