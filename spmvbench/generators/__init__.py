"""Matrix laws, one module each, found by a configuration's ``generator``.

Each module has ``generate(config: dict, seed: int, device) -> Matrix``
(host arrays; ``device`` is the run's, where the law draws on it); the
same seed gives the same matrix.
"""
