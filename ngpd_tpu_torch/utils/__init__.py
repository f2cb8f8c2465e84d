from .prof import Timer, profile_trace, recorded, span, time_fn  # noqa: F401
