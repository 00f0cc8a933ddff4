"""The paper's FL models behind the `FLModel` API, and the decoder LLMs
behind the `ModelAPI` (`api.get_model_api`)."""
