"""Optional JSON config file for the daemons.

The reference *documents* a config-file mechanism that exists nowhere in
its code (configuration.md CONFIG_FILE_PATH — SURVEY.md section 2 row 17
flags the drift). This implements the real thing: ``--config FILE`` loads
JSON whose keys are flag names (dashes or underscores), applied as parser
defaults so explicit command-line flags always win. Unknown keys are an
error — silent typos are how doc drift starts.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence


class ConfigFileError(ValueError):
    pass


def parse_daemon_args(parser: argparse.ArgumentParser, argv, prog: str):
    """Shared daemon entry parse: config-file-aware, errors to stderr.

    Returns the parsed namespace, or None after printing the error (the
    caller returns exit code 1) — one home for the boilerplate all three
    daemons share.
    """
    import sys

    try:
        return parse_with_config_file(parser, argv)
    except ConfigFileError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return None


def add_config_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--config", default=None, metavar="FILE",
        help="JSON config file; keys are flag names, command-line flags "
        "override file values",
    )


def parse_with_config_file(
    parser: argparse.ArgumentParser, argv: Optional[Sequence[str]]
) -> argparse.Namespace:
    """Two-phase parse: find --config, fold its values in as defaults,
    then parse for real."""
    pre, _ = parser.parse_known_args(argv)
    config_path = getattr(pre, "config", None)
    if not config_path:
        return parser.parse_args(argv)
    try:
        with open(config_path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except OSError as e:
        raise ConfigFileError(f"cannot read config file {config_path}: {e}") from None
    except json.JSONDecodeError as e:
        raise ConfigFileError(f"config file {config_path} is not valid JSON: {e}") from None
    if not isinstance(data, dict):
        raise ConfigFileError(f"config file {config_path} must hold a JSON object")

    actions_by_dest = {a.dest: a for a in parser._actions}
    defaults = {}
    unknown: List[str] = []
    for key, value in data.items():
        dest = key.replace("-", "_")
        action = actions_by_dest.get(dest)
        if action is None or dest == "config":
            unknown.append(key)
            continue
        # set_defaults bypasses argparse's type= conversion, so apply it
        # here — a quoted number must fail (or convert) at startup, not
        # explode later at a comparison deep in a daemon thread.
        if action.type is not None and isinstance(value, str):
            try:
                value = action.type(value)
            except (TypeError, ValueError) as e:
                raise ConfigFileError(
                    f"bad value for {key!r} in {config_path}: {e}"
                ) from None
        defaults[dest] = value
    if unknown:
        raise ConfigFileError(
            f"unknown config keys in {config_path}: {sorted(unknown)}"
        )
    parser.set_defaults(**defaults)
    return parser.parse_args(argv)
