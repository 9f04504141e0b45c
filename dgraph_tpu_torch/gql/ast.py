"""GraphQL± AST node types.

Semantic mirror of the reference's gql.GraphQuery / gql.Function /
gql.FilterTree (gql/parser.go:47,155,168) — same information content,
Python dataclasses instead of one large struct, and the planner-facing
fields (pagination, order) are typed instead of living in a string map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

UID_VAR = 1
VALUE_VAR = 2
ANY_VAR = 0


@dataclass
class VarContext:
    """A variable this node consumes. Ref gql.VarContext (parser.go:139)."""

    name: str
    typ: int  # UID_VAR | VALUE_VAR | ANY_VAR


@dataclass
class Arg:
    """Function argument. Ref gql.Arg (parser.go:161)."""

    value: str
    is_value_var: bool = False   # val(x)
    is_graphql_var: bool = False  # $x


@dataclass
class Function:
    """A root/filter function call like eq(name, "x").
    Ref gql.Function (parser.go:168)."""

    name: str
    attr: str = ""
    lang: str = ""
    args: list[Arg] = field(default_factory=list)
    uids: list[int] = field(default_factory=list)
    needs_var: list[VarContext] = field(default_factory=list)
    is_count: bool = False      # eq(count(friend), 2)
    is_value_var: bool = False  # eq(val(v), 5)
    is_len_var: bool = False    # eq(len(v), 5)


@dataclass
class FilterTree:
    """Boolean combination of functions. Ref gql.FilterTree (parser.go:155)."""

    op: str = ""  # "and" | "or" | "not" | "" (leaf)
    children: list["FilterTree"] = field(default_factory=list)
    func: Optional[Function] = None


@dataclass
class Order:
    """One sort key. Ref pb.Order."""

    attr: str
    desc: bool = False
    lang: str = ""


@dataclass
class RecurseArgs:
    """@recurse(depth: N, loop: true). Ref gql.RecurseArgs (parser.go:92)."""

    depth: int = 0
    allow_loop: bool = False


@dataclass
class ShortestArgs:
    """shortest(from:, to:, numpaths:, depth:).
    Ref gql.ShortestPathArgs (parser.go:100)."""

    from_: Optional[Function] = None
    to: Optional[Function] = None
    numpaths: int = 1
    depth: int = 0
    minweight: float = float("-inf")
    maxweight: float = float("inf")


@dataclass
class GroupByAttr:
    attr: str
    alias: str = ""
    lang: str = ""


@dataclass
class MathTree:
    """Math expression tree. Ref gql.MathTree (math.go)."""

    fn: str = ""                 # operator or "" for leaf
    const: Optional[float] = None
    var: str = ""
    children: list["MathTree"] = field(default_factory=list)


@dataclass
class FacetParams:
    all_keys: bool = False
    keys: list[tuple[str, str]] = field(default_factory=list)  # (key, alias)


@dataclass
class GraphQuery:
    """One query block / nested predicate node.
    Ref gql.GraphQuery (gql/parser.go:47)."""

    attr: str = ""
    alias: str = ""
    langs: list[str] = field(default_factory=list)
    uids: list[int] = field(default_factory=list)
    func: Optional[Function] = None
    filter: Optional[FilterTree] = None
    order: list[Order] = field(default_factory=list)
    first: Optional[int] = None
    offset: int = 0
    after: int = 0
    children: list["GraphQuery"] = field(default_factory=list)
    is_count: bool = False
    is_internal: bool = False
    var: str = ""                       # `x as ...`
    needs_var: list[VarContext] = field(default_factory=list)
    expand: str = ""                    # expand(_all_) / expand(var)
    recurse: Optional[RecurseArgs] = None
    shortest: Optional[ShortestArgs] = None
    cascade: bool = False
    normalize: bool = False
    ignore_reflex: bool = False
    groupby: list[GroupByAttr] = field(default_factory=list)
    is_groupby: bool = False
    math: Optional[MathTree] = None
    agg_func: str = ""                  # min/max/sum/avg at value level
    agg_pred: str = ""                  # max(name): aggregate a
                                        # predicate (groupby only)
    facets: Optional[FacetParams] = None
    facets_filter: Optional[FilterTree] = None
    facet_var: dict = field(default_factory=dict)
    checkpwd_pwd: Optional[str] = None  # checkpwd(pred, "plain") field
    is_empty: bool = False              # var-only block with no func


@dataclass
class ParsedResult:
    """Ref gql.Result (parser.go:210)."""

    queries: list[GraphQuery] = field(default_factory=list)
    query_vars: list[str] = field(default_factory=list)
    # `schema {}` / `schema(pred: [..]) { fields }` introspection block
    # (ref gql.Parse handling of itemLeftCurl+schema, parser.go:524 →
    # Result.Schema): None = not requested; {"preds": [...], "fields":
    # [...]} with empty lists meaning "all"
    schema_request: Optional[dict] = None
    # document-level `@explain` flag: "" (off), "plan" (EXPLAIN) or
    # "analyze" (EXPLAIN ANALYZE). A request annotation — it rides in
    # extensions.explain and never changes execution or the data bytes
    explain: str = ""
