"""Version/buildtime identifiers (reference: src/poporon.c:365-373)."""

VERSION_ID = 20000000  # matches reference POPORON_VERSION_ID (common.h:29)
BUILDTIME = 0


def version_id() -> int:
    return VERSION_ID


def buildtime() -> int:
    return BUILDTIME
