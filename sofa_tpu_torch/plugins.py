"""Plugins (the JAX package's ``sofa_tpu/plugins.py``): ``--plugin mod`` or
``--plugin mod:func`` imports ``mod`` at CLI start and calls ``func``
(default: the module's last name) with the SofaConfig, which it may
change.  A plugin may register analysis passes
(``analysis.registry.analysis_pass`` / ``register_pass``); what it
registers while it loads is tagged ``plugin:<spec>`` in ``passes`` and
``meta.passes``, and runs fault-isolated like any pass.  A plugin that
does not import, has no entry point or raises is skipped with an error
line, and the verb goes on.
"""

from __future__ import annotations

import importlib

from sofa_tpu_torch.printing import print_error, print_info


def load_plugins(cfg) -> None:
    from sofa_tpu_torch.analysis import registry

    for spec in cfg.plugins:
        mod_name, _, func_name = spec.partition(":")
        with registry.plugin_origin(spec):
            try:
                mod = importlib.import_module(mod_name)
            # an import that raises, whatever it raises, is a failed import
            except Exception as e:  # noqa: BLE001
                print_error(f"plugin {spec!r}: cannot import {mod_name!r}: "
                            f"{type(e).__name__}: {e}")
                continue
            func = getattr(mod, func_name or mod_name.rsplit(".", 1)[-1],
                           None)
            if not callable(func):
                print_error(f"plugin {spec!r}: no callable entry point")
                continue
            try:
                func(cfg)
            # one bad plugin must not end the verb
            except Exception as e:  # noqa: BLE001
                print_error(f"plugin {spec!r}: entry point raised "
                            f"{type(e).__name__}: {e} — plugin skipped")
                continue
        print_info(f"plugin {spec!r} loaded")
