"""``shipping_steps_per_query``: see ``readers.shipping_steps_per_query``."""
from rdfbench.readers import shipping_steps_per_query as read  # noqa: F401
