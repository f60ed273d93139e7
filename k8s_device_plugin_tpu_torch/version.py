"""Single source of truth for the package version.

The reference stamps its version at link time via
``-ldflags -X main.gitDescribe=$(git describe)`` (reference Dockerfile:22-23);
here the build stamps ``GIT_DESCRIBE`` into the image environment and the
binaries fall back to this static version when unset.
"""

import os

VERSION = "0.1.0"


def git_describe() -> str:
    """Version banner string: env override (set by image builds) or VERSION."""
    return os.environ.get("GIT_DESCRIBE", VERSION)
