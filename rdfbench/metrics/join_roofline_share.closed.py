"""``join_roofline_share.closed``: see ``readers.join_roofline_share``."""
from rdfbench.readers import join_roofline_share as read  # noqa: F401
