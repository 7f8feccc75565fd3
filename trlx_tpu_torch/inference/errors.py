"""Exception classes the scheduler names for multi-tenant adapters, a
feature this package has not ported yet (ROADMAP queue A, item 4, with
LoRA). They are plain copies so the copied control flow stays intact;
nothing in this package raises them until adapters land. The session
errors live with the session store (`inference/sessions.py`)."""


class AdapterError(RuntimeError):
    """Base class for adapter-store failures."""


class AdapterCapacityError(AdapterError):
    """The request set needs more adapter slots than are free."""
