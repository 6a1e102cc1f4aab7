"""Synthetic relational workloads (star / chain / snowflake)."""
from .generators import chain_schema, snowflake_schema, star_schema

__all__ = ["chain_schema", "snowflake_schema", "star_schema"]
