"""Core SQL+ML feature-query engine.

    from repro_torch.core import Engine, OptFlags, parse_sql, QueryBuilder
"""
from repro_torch.core.dsl import (QueryBuilder, parse_sql, col, lit, sum_,
                                  count_, avg_, min_, max_, std_, var_,
                                  first_, last_)
from repro_torch.core.engine import (Engine, Deployment, DeploymentHandle,
                                     EngineStats, HandleMetrics)
from repro_torch.core.optimizer import OptFlags, TableMeta, optimize
from repro_torch.core.logical import Query, LogicalPlan
from repro_torch.core.plan_cache import (PlanCache, CacheStats, TagStats,
                                         bucket_batch)
from repro_torch.core.results import (FeatureFrame, RequestContext,
                                      DeadlineExceeded, STATUS_OK,
                                      STATUS_UNKNOWN_KEY)

__all__ = [
    "Engine", "Deployment", "DeploymentHandle", "EngineStats",
    "HandleMetrics", "OptFlags", "TableMeta", "optimize", "Query",
    "LogicalPlan", "PlanCache", "CacheStats", "TagStats", "bucket_batch",
    "FeatureFrame",
    "RequestContext", "DeadlineExceeded", "STATUS_OK", "STATUS_UNKNOWN_KEY",
    "QueryBuilder", "parse_sql", "col", "lit", "sum_", "count_", "avg_",
    "min_", "max_", "std_", "var_", "first_", "last_",
]
