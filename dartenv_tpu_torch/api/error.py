"""Error taxonomy (reference: `gym/error.py` † — SURVEY.md §2.1)."""


class Error(Exception):
    pass


class Unregistered(Error):
    """Raised when the user requests an item from the registry that does
    not actually exist."""


class UnregisteredEnv(Unregistered):
    pass


class DeprecatedEnv(Error):
    """Raised when the user requests an env from the registry where the
    version is older than the latest registered version."""


class UnseedableEnv(Error):
    pass


class DependencyNotInstalled(Error):
    pass


class ResetNeeded(Error):
    """When the monitor is active, raised when the env needs a reset."""


class ResetNotAllowed(Error):
    pass


class InvalidAction(Error):
    pass
