"""``device_idle_share.closed``: see ``readers.device_idle_share``."""
from rdfbench.readers import device_idle_share as read  # noqa: F401
