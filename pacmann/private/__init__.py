"""Private search: PIR-backed vertex oracle + end-to-end driver."""

from pacmann.private.oracle import PIRGraphOracle, pack_vertex_db, unpack_entries  # noqa: F401
from pacmann.private.driver import (  # noqa: F401
    PrivateSearchConfig,
    PrivateSearchResult,
    run_private_search,
)
