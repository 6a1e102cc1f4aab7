"""Seconds the port takes to build the schema (``Schema(...)`` to a
synchronize): host key dictionaries, join trees, CSRs, device copies."""


def read(trace):
    return trace.counters.get("schema_build_s")
