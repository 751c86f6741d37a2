"""Config-file override engine — the nanoGPT ``configurator.py`` equivalent
(a copy of ``mapf_gpt_tpu/utils/configurator.py``).

The reference configures training by exec()ing a config file over the
script's globals and then applying ``--key=value`` literal-eval overrides
with a type check (ref:experiment_setup/configurator.py:4-31, hooked at
ref:train.py:81).  Here the same semantics apply to an argparse Namespace:

    apply_config(args, config_file="cfg.py", overrides=["--max_iters=100"])

The config file is a python script assigning plain names
(``batch_size = 2048``); only names already present on the namespace may be
set, and the value's type must match the current value's type.
"""

from __future__ import annotations

from ast import literal_eval
from typing import Iterable


def apply_config(ns, config_file: str | None = None,
                 overrides: Iterable[str] = ()) -> None:
    known = {k.replace("-", "_") for k in vars(ns)}

    def set_key(key: str, value) -> None:
        key = key.replace("-", "_")
        if key not in known:
            raise ValueError(f"unknown config key: {key}")
        current = getattr(ns, key)
        if current is not None and value is not None \
                and not isinstance(value, type(current)):
            raise TypeError(
                f"type mismatch for {key}: {type(value).__name__} vs "
                f"{type(current).__name__}")
        setattr(ns, key, value)

    if config_file:
        scope: dict = {}
        with open(config_file) as f:
            exec(f.read(), scope)
        for k, v in scope.items():
            if not k.startswith("_") and not callable(v) \
                    and not isinstance(v, type(literal_eval)):
                if k.replace("-", "_") in known:
                    set_key(k, v)

    for ov in overrides:
        assert ov.startswith("--") and "=" in ov, ov
        key, raw = ov[2:].split("=", 1)
        try:
            value = literal_eval(raw)
        except (SyntaxError, ValueError):
            value = raw
        set_key(key, value)
