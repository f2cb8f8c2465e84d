from .prof import Timer, profile_trace, time_fn  # noqa: F401
