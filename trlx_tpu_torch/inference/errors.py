"""Exception classes the scheduler and server name for features this
package has not ported yet (multi-tenant adapters, chat sessions). They
are plain copies so the copied control flow stays intact; nothing in
this package raises them until those features land (ROADMAP queue A)."""


class AdapterError(RuntimeError):
    """Base class for adapter-store failures."""


class AdapterCapacityError(AdapterError):
    """The request set needs more adapter slots than are free."""


class SessionError(RuntimeError):
    """Base class for session-layer refusals."""
