"""Host-side statistics of the class API (numpy only)."""
