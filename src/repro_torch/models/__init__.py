"""The paper's FL models behind the `FLModel` API."""
