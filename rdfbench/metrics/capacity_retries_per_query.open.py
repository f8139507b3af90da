"""``capacity_retries_per_query.open``: see ``readers.capacity_retries_per_query``."""
from rdfbench.readers import capacity_retries_per_query as read  # noqa: F401
