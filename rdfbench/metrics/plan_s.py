"""``plan_s``: see ``readers.plan_s``."""
from rdfbench.readers import plan_s as read  # noqa: F401
