"""``door_batch_size.open``: see ``readers.door_batch_size``."""
from rdfbench.readers import door_batch_size as read  # noqa: F401
