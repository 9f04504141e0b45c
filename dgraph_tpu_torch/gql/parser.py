"""GraphQL± recursive-descent parser.

Covers the reference's query surface (gql.Parse, gql/parser.go:524):
query blocks with root functions, GraphQL variables, fragments, filters
with and/or/not, pagination (first/offset/after), multi-key ordering,
aliases, language tags, count blocks, value/uid variables (`x as ...`),
aggregations (min/max/sum/avg), math blocks, groupby, facets, expand(),
@recurse, @cascade, @normalize, @ignorereflex, and shortest-path blocks.

Built as a fresh recursive-descent over a regex token stream — not a
translation of the reference's lexer-state machinery.
"""

from __future__ import annotations

from dgraph_tpu_torch.gql.ast import (
    ANY_VAR, UID_VAR, VALUE_VAR,
    Arg, FacetParams, FilterTree, Function, GraphQuery, GroupByAttr,
    MathTree, Order, ParsedResult, RecurseArgs, ShortestArgs, VarContext,
)
from dgraph_tpu_torch.gql.lexer import Cursor, GQLError, Token, tokenize

_ROOT_FUNCS = {
    "eq", "le", "lt", "ge", "gt", "between", "has", "uid", "uid_in",
    "anyofterms", "allofterms", "anyoftext", "alloftext", "regexp",
    "match", "near", "within", "contains", "intersects", "type",
    "anyof", "allof", "similar_to",
}
_AGG_FUNCS = {"min", "max", "sum", "avg"}
# every name _parse_function accepts (root funcs + the filter-capable
# extras; the executor rejects len() outside @filter)
_QUERY_FUNCS = _ROOT_FUNCS | {"checkpwd", "len"}
_DIRECTIVES = {"filter", "facets", "cascade", "normalize", "ignorereflex",
               "recurse", "groupby"}
_BOOL_OPS = {"and", "or", "not"}

def _to_int(raw: str, line: int = 0) -> int:
    """Numeric literal -> int with a clean GQLError on junk the lexer
    let through (e.g. '020000': base-0 rejects leading zeros — found by
    the fuzz suite, ref gql/parser_fuzz.go contract)."""
    try:
        return int(raw, 0)
    except ValueError as e:
        raise GQLError(f"line {line}: bad integer literal {raw!r}") from e



def parse(text: str, variables: dict | None = None) -> ParsedResult:
    """Parse a full query document.  `variables` supplies values for
    GraphQL `$vars` (ref gql.Request.Variables)."""
    cur = Cursor(tokenize(text), src=text)
    vars_decl: dict[str, str | None] = {}
    res = ParsedResult()
    fragments: dict[str, GraphQuery] = {}

    while cur.peek().kind != "eof":
        t = cur.peek()
        if t.kind == "at":
            # document-level `@explain` / `@explain(analyze: true)`:
            # the request asks for its compiled plan tree (EXPLAIN) or
            # the executed-and-measured version (EXPLAIN ANALYZE) in
            # extensions.explain. A flag on the request, not a query
            # block — execution itself is unchanged.
            cur.next()
            d = cur.expect("name", "directive").val.lower()
            if d != "explain":
                raise GQLError(
                    f"line {t.line}: unknown document directive @{d}")
            mode = "plan"
            if cur.accept("lparen"):
                key = cur.expect("name", "explain option").val.lower()
                cur.expect("colon")
                val = cur.next().val.lower()
                cur.expect("rparen")
                if key != "analyze":
                    raise GQLError(
                        f"line {t.line}: unknown @explain option "
                        f"{key!r} (only 'analyze')")
                if val == "true":
                    mode = "analyze"
                elif val != "false":
                    raise GQLError(
                        f"line {t.line}: @explain(analyze:) must be "
                        f"true or false, got {val!r}")
            # repeated directives keep the STRONGER mode — same rule
            # the transport-flag/document-directive combiner applies
            if res.explain != "analyze":
                res.explain = mode
        elif t.kind == "name" and t.val == "query":
            cur.next()
            if cur.peek().kind == "name":  # optional op name
                cur.next()
            if cur.peek().kind == "lparen":
                vars_decl = _parse_var_decls(cur)
            _parse_block_set(cur, res, _resolve_vars(vars_decl, variables))
        elif t.kind == "name" and t.val == "fragment":
            cur.next()
            name = cur.expect("name", "fragment name").val
            frag = GraphQuery(attr=f"fragment/{name}")
            cur.expect("lbrace")
            _parse_selection_set(cur, frag, {})
            fragments[name] = frag
        elif t.kind == "lbrace":
            _parse_block_set(cur, res, _resolve_vars(vars_decl, variables))
        elif t.kind == "name" and t.val == "schema":
            # bare `schema {}` / `schema(pred: [..]) { fields }` at the
            # document top level (ref gql parser's schema handling)
            cur.next()
            _parse_schema_block(cur, res)
        else:
            raise GQLError(
                f"line {t.line}: unexpected {t.val!r} at document top level")

    for q in res.queries:
        _expand_fragments(q, fragments, set())
        _collect_needs(q, res)
    _check_duplicates(res)
    return res


def _check_duplicates(res: ParsedResult):
    """Reject duplicate emitting-block aliases and vars defined more
    than once (ref gql/parser.go validate: 'Duplicate aliases not
    allowed' + 'Variable ... defined multiple times') — accepting them
    silently drops or shadows one block's results."""
    names: set[str] = set()
    seen_vars: set[str] = set()

    def walk(gq):
        if gq.var:
            if gq.var in seen_vars:
                raise GQLError(
                    f"variable {gq.var!r} is defined multiple times")
            seen_vars.add(gq.var)
        for v in (gq.facet_var or {}).values():
            if v in seen_vars:
                raise GQLError(
                    f"variable {v!r} is defined multiple times")
            seen_vars.add(v)
        for c in gq.children:
            walk(c)

    for q in res.queries:
        nm = q.alias or q.attr
        if nm and nm not in ("var", "shortest"):
            if nm in names:
                raise GQLError(f"duplicate query alias {nm!r}")
            names.add(nm)
        walk(q)


def _resolve_vars(decl: dict, provided: dict | None) -> dict[str, str]:
    out = {}
    # clients pass keys with the dollar sign ("$a": "2" — the
    # reference's api.Request.Vars convention); decls store bare
    # names. Strip ONE leading "$" ("$$a" must stay "$a", not collapse
    # to "a"), and reject a bare/"$"-prefixed duplicate pair — which
    # key wins would otherwise be dict-order roulette (ADVICE round 5)
    norm: dict[str, str] = {}
    for k, v in (provided or {}).items():
        key = k[1:] if k.startswith("$") else k
        if key in norm:
            raise GQLError(
                f"duplicate GraphQL variable {key!r} "
                "(supplied both bare and $-prefixed)")
        norm[key] = v
    provided = norm
    for name, default in decl.items():
        if name in provided:
            out[name] = str(provided[name])
        elif default is not None:
            out[name] = default
        else:
            raise GQLError(f"variable {name} not supplied and has no default")
    # allow extra provided vars even without declaration (reference is
    # stricter; being lenient here only widens accepted inputs)
    for k, v in provided.items():
        out.setdefault(k, str(v))
    return out


def _parse_var_decls(cur: Cursor) -> dict[str, str | None]:
    cur.expect("lparen")
    out: dict[str, str | None] = {}
    while not cur.accept("rparen"):
        tok = cur.expect("dollar", "$variable")
        cur.expect("colon")
        cur.expect("name", "variable type")  # int/float/bool/string — unused
        if cur.accept("op", "="):
            d = cur.next()
            out[tok.val[1:]] = d.val
        else:
            out[tok.val[1:]] = None
        cur.accept("comma")
    return out


def _parse_block_set(cur: Cursor, res: ParsedResult, gvars: dict):
    cur.expect("lbrace")
    while not cur.accept("rbrace"):
        t = cur.peek()
        if t.kind == "name" and t.val == "schema":
            cur.next()
            _parse_schema_block(cur, res)
            continue
        res.queries.append(_parse_block(cur, gvars))


def _parse_schema_block(cur: Cursor, res: ParsedResult):
    """`schema {}` / `schema(pred: [name, age]) { type index tokenizer }`
    — schema introspection through the query language (ref gql
    schema-block parsing; query response carries a "schema" array)."""
    preds: list[str] = []
    fields: list[str] = []
    if cur.accept("lparen"):
        key = cur.expect("name", "schema arg").val
        if key != "pred":
            raise GQLError(f"schema block: unknown argument {key!r}")
        cur.expect("colon")
        if cur.accept("lbracket"):
            while not cur.accept("rbracket"):
                tok = cur.next()
                if tok.kind not in ("name", "string"):
                    raise GQLError(
                        f"line {tok.line}: schema pred list expects "
                        f"predicate names, got {tok.val!r}")
                preds.append(tok.val.strip('"'))
                cur.accept("comma")
        else:
            tok = cur.next()
            if tok.kind not in ("name", "string"):
                raise GQLError(
                    f"line {tok.line}: schema pred expects a "
                    f"predicate name, got {tok.val!r}")
            preds.append(tok.val.strip('"'))
        cur.expect("rparen")
    cur.expect("lbrace")
    while not cur.accept("rbrace"):
        fields.append(cur.expect("name", "schema field").val)
    if res.schema_request is not None:
        raise GQLError("only one schema block per query")
    res.schema_request = {"preds": preds, "fields": fields}


def _parse_block(cur: Cursor, gvars: dict) -> GraphQuery:
    gq = GraphQuery()
    name_tok = cur.expect("name", "query block name")
    # `x as blockname(...)` defines a block-level uid var
    if cur.peek().kind == "name" and cur.peek().val == "as":
        cur.next()
        gq.var = name_tok.val
        name_tok = cur.expect("name", "query block name")
    gq.alias = name_tok.val

    if name_tok.val == "shortest":
        gq.attr = "shortest"
        gq.shortest = _parse_shortest_args(cur, gvars)
    else:
        if cur.peek().kind == "lparen":
            _parse_root_args(cur, gq, gvars)
        else:
            gq.is_empty = True
    while cur.peek().kind == "at":
        _parse_directive(cur, gq, gvars)
    if cur.peek().kind == "lbrace":
        cur.next()
        _parse_selection_set(cur, gq, gvars)
    return gq


def _parse_root_args(cur: Cursor, gq: GraphQuery, gvars: dict):
    cur.expect("lparen")
    while not cur.accept("rparen"):
        key = cur.expect("name", "root argument").val
        cur.expect("colon")
        if key == "func":
            gq.func = _parse_function(cur, gvars)
            if gq.func.name == "uid":
                gq.uids = list(gq.func.uids)
                for v in gq.func.needs_var:
                    gq.needs_var.append(v)
        elif key in ("first", "offset", "after"):
            _set_pagination(gq, key, _scalar_str(cur, gvars))
        elif key in ("orderasc", "orderdesc"):
            attr, lang = _pred_with_lang_str(cur)
            gq.order.append(Order(attr, desc=(key == "orderdesc"), lang=lang))
        elif key == "id":
            raise GQLError("id argument was removed; use func: uid(...)")
        else:
            raise GQLError(f"unknown root argument {key!r}")
        cur.accept("comma")
    if gq.func is None and not gq.uids and not gq.needs_var:
        gq.is_empty = True


def _set_pagination(gq: GraphQuery, key: str, raw: str):
    try:
        v = _to_int(raw)
    except ValueError as e:
        raise GQLError(f"{key} must be an integer, got {raw!r}") from e
    if key == "first":
        gq.first = v
    elif key == "offset":
        gq.offset = v
    else:
        gq.after = v


def _scalar_str(cur: Cursor, gvars: dict) -> str:
    t = cur.next()
    if t.kind == "dollar":
        name = t.val[1:]
        if name not in gvars:
            raise GQLError(f"undefined GraphQL variable ${name}")
        return gvars[name]
    if t.kind in ("number", "string", "name", "hex"):
        return t.val
    raise GQLError(f"line {t.line}: expected scalar, got {t.val!r}")


def _pred_with_lang_str(cur: Cursor) -> tuple[str, str]:
    """`pred` or `pred@lang` or val(x) for order args."""
    t = cur.expect("name", "predicate")
    if t.val == "val" and cur.peek().kind == "lparen":
        cur.next()
        v = cur.expect("name", "variable").val
        cur.expect("rparen")
        return f"val({v})", ""
    lang = ""
    if cur.accept("at"):
        lang = "." if cur.accept("dot") \
            else cur.expect("name", "language").val
    return t.val, lang


# -- functions ---------------------------------------------------------------


def _parse_function(cur: Cursor, gvars: dict) -> Function:
    name_tok = cur.expect("name", "function name")
    fname = name_tok.val.lower()
    if fname not in _QUERY_FUNCS:
        # min/max etc. are not query functions (ref gql
        # validateFunction: "Function name: min is not valid" —
        # query0:TestVarInAggError). len() is only legal inside
        # @filter, which the executor enforces.
        raise GQLError(
            f"line {name_tok.line}: function name {fname!r} "
            "is not valid")
    fn = Function(name=fname)
    cur.expect("lparen")

    if fname == "uid":
        while not cur.accept("rparen"):
            t = cur.next()
            if t.kind in ("hex", "number"):
                fn.uids.append(_to_int(t.val, t.line))
            elif t.kind == "name":
                fn.needs_var.append(VarContext(t.val, UID_VAR))
            else:
                raise GQLError(f"line {t.line}: bad uid() argument {t.val!r}")
            cur.accept("comma")
        return fn
    if fname == "type":
        fn.args.append(Arg(cur.expect("name", "type name").val))
        cur.expect("rparen")
        return fn

    # first argument: attribute | count(attr) | val(var) | len(var) | uid
    t = cur.peek()
    if t.kind == "name" and t.val == "count":
        cur.next()
        cur.expect("lparen")
        fn.attr = cur.expect("name", "attribute").val
        cur.expect("rparen")
        fn.is_count = True
    elif t.kind == "name" and t.val == "val":
        cur.next()
        cur.expect("lparen")
        v = cur.expect("name", "variable").val
        fn.needs_var.append(VarContext(v, VALUE_VAR))
        fn.is_value_var = True
        cur.expect("rparen")
    elif t.kind == "name" and t.val == "len":
        cur.next()
        cur.expect("lparen")
        v = cur.expect("name", "variable").val
        fn.needs_var.append(VarContext(v, ANY_VAR))
        fn.is_len_var = True
        cur.expect("rparen")
    else:
        fn.attr = cur.expect("name", "attribute").val
        if cur.accept("at"):
            # `pred@en` or `pred@.` (any language)
            fn.lang = "." if cur.accept("dot") \
                else cur.expect("name", "language").val

    cur.accept("comma")
    while not cur.accept("rparen"):
        t = cur.next()
        if t.kind == "lbracket" and fname in (
                "near", "within", "contains", "intersects",
                "similar_to"):
            # geo coordinate / vector literal: keep the (possibly
            # nested) list structure as one argument (ref
            # gql/parser.go parseGeoArgs; similar_to's query vector
            # may be a bare [0.1, 0.2, ...] literal like Dgraph's)
            fn.args.append(Arg(_parse_coord_list(cur)))
        elif t.kind == "lbracket":
            while not cur.accept("rbracket"):
                inner = cur.next()
                if inner.kind == "dollar":
                    fn.args.append(Arg(gvars[inner.val[1:]], is_graphql_var=True))
                elif inner.kind == "name" and inner.val == "val":
                    cur.expect("lparen")
                    v = cur.expect("name").val
                    cur.expect("rparen")
                    fn.needs_var.append(VarContext(v, VALUE_VAR))
                    fn.args.append(Arg(v, is_value_var=True))
                else:
                    fn.args.append(Arg(inner.val))
                cur.accept("comma")
        elif t.kind == "dollar":
            name = t.val[1:]
            if name not in gvars:
                raise GQLError(f"undefined GraphQL variable ${name}")
            val = gvars[name]
            if fname == "regexp":
                # a regexp argument supplied via GraphQL variable
                # carries the /pattern/flags form (ref query4:
                # TestRegExpVariableReplacement); require BOTH
                # slashes like the literal lexer does — "/i" must not
                # silently become an empty match-everything pattern
                if len(val) < 2 or not val.startswith("/") \
                        or "/" not in val[1:]:
                    raise GQLError(
                        f"regexp variable ${name} must carry "
                        f"/pattern/flags, got {val!r}")
                body, _, flags = val[1:].rpartition("/")
                if not body:
                    # "//i" would otherwise compile to an empty
                    # match-everything pattern (ADVICE round 5)
                    raise GQLError(
                        f"regexp variable ${name} has an empty "
                        f"pattern body, got {val!r}")
                fn.args.append(Arg(body))
                if flags:
                    fn.args.append(Arg(flags))
            else:
                fn.args.append(Arg(val, is_graphql_var=True))
        elif t.kind == "name" and t.val == "val" and cur.peek().kind == "lparen":
            cur.next()
            v = cur.expect("name", "variable").val
            cur.expect("rparen")
            fn.needs_var.append(VarContext(v, VALUE_VAR))
            fn.args.append(Arg(v, is_value_var=True))
        elif t.kind == "name" and t.val == "uid" and cur.peek().kind == "lparen":
            # uid_in(pred, uid(v)) form
            cur.next()
            while not cur.accept("rparen"):
                u = cur.next()
                if u.kind in ("hex", "number"):
                    fn.uids.append(_to_int(u.val, u.line))
                else:
                    fn.needs_var.append(VarContext(u.val, UID_VAR))
                cur.accept("comma")
        elif t.kind in ("string", "number", "hex", "name"):
            if fname in ("uid_in",) and t.kind in ("hex", "number"):
                fn.uids.append(_to_int(t.val, t.line))
            else:
                fn.args.append(Arg(t.val))
        elif t.kind == "regex":
            # /pattern/flags scanned contextually by the lexer
            pat, _, flags = t.val.partition("\x00")
            fn.args.append(Arg(pat))
            if flags:
                fn.args.append(Arg(flags))
        else:
            raise GQLError(f"line {t.line}: bad function argument {t.val!r}")
        cur.accept("comma")
    return fn


def _parse_coord_list(cur: Cursor) -> list:
    """After an opening '[': numbers / nested lists until ']'."""
    out: list = []
    while not cur.accept("rbracket"):
        t = cur.next()
        if t.kind == "lbracket":
            out.append(_parse_coord_list(cur))
        elif t.kind == "number":
            out.append(float(t.val))
        else:
            raise GQLError(
                f"line {t.line}: bad coordinate literal {t.val!r}")
        cur.accept("comma")
    return out


# -- filters -----------------------------------------------------------------


def _parse_filter(cur: Cursor, gvars: dict) -> FilterTree:
    cur.expect("lparen")
    tree = _parse_filter_or(cur, gvars)
    cur.expect("rparen")
    return tree


def parse_cond(text: str) -> FilterTree | None:
    """Parse an upsert conditional mutation's `@if(...)` expression
    (ref gql.ParseMutation conditional handling, gql/parser_mutation.go:26
    + edgraph/server.go:220 doMutate cond evaluation)."""
    text = (text or "").strip()
    if not text:
        return None
    if text.startswith("@if"):
        text = text[3:].lstrip()
    cur = Cursor(tokenize(text), src=text)
    tree = _parse_filter(cur, {})
    t = cur.peek()
    if t.kind != "eof":
        raise GQLError(f"line {t.line}: trailing input in @if condition")
    return tree


def _parse_filter_or(cur: Cursor, gvars: dict) -> FilterTree:
    left = _parse_filter_and(cur, gvars)
    children = [left]
    while _peek_bool_op(cur) == "or":
        cur.next()
        children.append(_parse_filter_and(cur, gvars))
    if len(children) == 1:
        return left
    return FilterTree(op="or", children=children)


def _parse_filter_and(cur: Cursor, gvars: dict) -> FilterTree:
    left = _parse_filter_unary(cur, gvars)
    children = [left]
    while _peek_bool_op(cur) == "and":
        cur.next()
        children.append(_parse_filter_unary(cur, gvars))
    if len(children) == 1:
        return left
    return FilterTree(op="and", children=children)


def _parse_filter_unary(cur: Cursor, gvars: dict) -> FilterTree:
    if _peek_bool_op(cur) == "not":
        cur.next()
        return FilterTree(op="not", children=[_parse_filter_unary(cur, gvars)])
    if cur.peek().kind == "lparen":
        cur.next()
        t = _parse_filter_or(cur, gvars)
        cur.expect("rparen")
        return t
    fn = _parse_function(cur, gvars)
    return FilterTree(func=fn)


def _peek_bool_op(cur: Cursor) -> str | None:
    t = cur.peek()
    if t.kind == "name" and t.val.lower() in _BOOL_OPS:
        # 'not' must be followed by a function or '(' to count as an op
        return t.val.lower()
    return None


# -- directives --------------------------------------------------------------


def _parse_directive(cur: Cursor, gq: GraphQuery, gvars: dict):
    cur.expect("at")
    name = cur.expect("name", "directive").val.lower()
    if name == "filter":
        gq.filter = _parse_filter(cur, gvars)
    elif name == "cascade":
        gq.cascade = True
    elif name == "normalize":
        gq.normalize = True
    elif name == "ignorereflex":
        gq.ignore_reflex = True
    elif name == "recurse":
        ra = RecurseArgs()
        if cur.peek().kind == "lparen":
            cur.next()
            while not cur.accept("rparen"):
                key = cur.expect("name", "recurse arg").val
                cur.expect("colon")
                val = _scalar_str(cur, gvars)
                if key == "depth":
                    ra.depth = _to_int(val)
                elif key == "loop":
                    ra.allow_loop = val.lower() == "true"
                else:
                    raise GQLError(f"unknown recurse arg {key!r}")
                cur.accept("comma")
        gq.recurse = ra
    elif name == "groupby":
        gq.is_groupby = True
        cur.expect("lparen")
        while not cur.accept("rparen"):
            attr_tok = cur.expect("name", "groupby attr")
            alias = ""
            attr = attr_tok.val
            if cur.accept("colon"):
                alias = attr
                attr = cur.expect("name").val
            lang = ""
            if cur.accept("at"):
                lang = cur.expect("name").val
            gq.groupby.append(GroupByAttr(attr, alias, lang))
            cur.accept("comma")
    elif name == "facets":
        _parse_facets(cur, gq, gvars)
    else:
        raise GQLError(f"unknown directive @{name}")


def _parse_facets(cur: Cursor, gq: GraphQuery, gvars: dict):
    fp = gq.facets or FacetParams()
    if cur.peek().kind != "lparen":
        fp.all_keys = True
        gq.facets = fp
        return
    # Could be @facets(key1, alias: key2), @facets(eq(key, v)) filter,
    # @facets(v as key) var, or @facets(orderasc: key)
    save = cur.i
    cur.next()
    first = cur.peek()
    if first.kind == "name" and first.val.lower() in (
            "eq", "le", "lt", "ge", "gt", "allofterms", "anyofterms",
            "not", "and", "or"):
        cur.i = save
        gq.facets_filter = _parse_filter(cur, gvars)
        return
    while not cur.accept("rparen"):
        t = cur.expect("name", "facet key")
        if cur.peek().kind == "name" and cur.peek().val == "as":
            cur.next()
            key = cur.expect("name").val
            gq.facet_var[key] = t.val
        elif t.val in ("orderasc", "orderdesc") and cur.peek().kind == "colon":
            cur.next()
            key = cur.expect("name").val
            if any(not o.attr.startswith("facet:") for o in gq.order):
                # ordering by a predicate AND a facet together is
                # ambiguous (ref query0:TestDoubleOrder rejects it)
                raise GQLError(
                    "cannot order by both a predicate and a facet")
            # bare selection: alias None (an explicit alias — even one
            # spelled like its key — emits under the BARE alias; ref
            # facets:TestFacetsAlias)
            fp.keys.append((key, None))
            gq.order.append(Order(f"facet:{key}", desc=(t.val == "orderdesc")))
        elif cur.accept("colon"):
            key = cur.expect("name").val
            fp.keys.append((key, t.val))
        else:
            fp.keys.append((t.val, None))
        cur.accept("comma")
    gq.facets = fp


# -- shortest ----------------------------------------------------------------


def _parse_shortest_args(cur: Cursor, gvars: dict) -> ShortestArgs:
    sa = ShortestArgs()
    cur.expect("lparen")
    while not cur.accept("rparen"):
        key = cur.expect("name", "shortest arg").val
        cur.expect("colon")
        if key in ("from", "to"):
            t = cur.peek()
            fn = Function(name="uid")
            if t.kind in ("hex", "number"):
                cur.next()
                fn.uids.append(_to_int(t.val, t.line))
            elif t.kind == "name" and t.val == "uid":
                fn = _parse_function(cur, gvars)
            else:
                raise GQLError(f"bad shortest {key}: {t.val!r}")
            if key == "from":
                sa.from_ = fn
            else:
                sa.to = fn
        elif key == "numpaths":
            sa.numpaths = _to_int(_scalar_str(cur, gvars))
        elif key == "depth":
            sa.depth = _to_int(_scalar_str(cur, gvars))
        elif key == "minweight":
            sa.minweight = float(_scalar_str(cur, gvars))
        elif key == "maxweight":
            sa.maxweight = float(_scalar_str(cur, gvars))
        else:
            raise GQLError(f"unknown shortest arg {key!r}")
        cur.accept("comma")
    return sa


# -- selection sets ----------------------------------------------------------


def _parse_selection_set(cur: Cursor, parent: GraphQuery, gvars: dict):
    while not cur.accept("rbrace"):
        t = cur.peek()
        if t.kind == "spread":
            cur.next()
            frag = cur.expect("name", "fragment name").val
            parent.children.append(GraphQuery(attr=f"fragment/{frag}"))
            continue
        if t.kind != "name":
            raise GQLError(
                f"line {t.line}: expected predicate, got {t.val!r}")
        parent.children.append(_parse_selection(cur, gvars))


def _parse_selection(cur: Cursor, gvars: dict) -> GraphQuery:
    gq = GraphQuery()
    first = cur.expect("name")

    # `v as pred` variable binding
    if cur.peek().kind == "name" and cur.peek().val == "as":
        cur.next()
        gq.var = first.val
        first = cur.expect("name", "predicate after 'as'")

    # alias `alias : pred` (not `pred: lang` — langs use @)
    if cur.peek().kind == "colon":
        cur.next()
        gq.alias = first.val
        first = cur.expect("name", "predicate after alias")

    name = first.val

    if name == "count" and cur.peek().kind == "lparen":
        cur.next()
        inner = cur.expect("name", "count target")
        if inner.val == "val":
            raise GQLError("count(val(...)) is not supported; "
                           "aggregate through a var block")
        if inner.val == "uid":
            gq.attr = "uid"
            gq.is_count = True
            gq.is_internal = True
        else:
            gq.attr = inner.val
            gq.is_count = True
            for _ in range(2):  # @lang, then optionally @filter
                if not cur.accept("at"):
                    break
                if cur.peek().kind == "name" \
                        and cur.peek().val.lower() == "filter":
                    # count(pred @filter(...)) counts only the edges
                    # the filter keeps (ref query0_test.go
                    # TestQueryEmptyRoomsWithTermIndex)
                    cur.next()
                    gq.filter = _parse_filter(cur, gvars)
                    break
                gq.langs = _parse_langs(cur)
            if cur.peek().kind == "lparen":
                # count(pred ... (orderasc: dob)): ordering never
                # changes a count — parse and discard (ref
                # query2_test.go TestToFastJSONOrderDescCount)
                depth = 0
                while True:
                    t = cur.next()
                    if t.kind == "lparen":
                        depth += 1
                    elif t.kind == "rparen":
                        depth -= 1
                        if depth == 0:
                            break
                    elif t.kind == "eof":
                        raise GQLError("unbalanced count() arguments")
        cur.expect("rparen")
    elif name == "checkpwd" and cur.peek().kind == "lparen":
        # checkpwd(pred, "plain") as a result field emits
        # `checkpwd(pred): bool` per row (ref query3:TestCheckPassword)
        cur.next()
        pred = cur.expect("name", "password predicate").val
        cur.expect("comma")
        pwd = cur.expect("string", "password string")
        cur.expect("rparen")
        gq.attr = pred
        gq.checkpwd_pwd = pwd.val
        gq.is_internal = True
    elif name in _AGG_FUNCS and cur.peek().kind == "lparen":
        cur.next()
        gq.agg_func = name
        inner = cur.expect("name", "val")
        if inner.val == "val":
            cur.expect("lparen")
            v = cur.expect("name").val
            cur.expect("rparen")
            cur.expect("rparen")
            gq.attr = f"{name}(val({v}))"
            gq.needs_var.append(VarContext(v, VALUE_VAR))
            gq.is_internal = True
        else:
            # max(name) etc: aggregate a PREDICATE's values — only
            # meaningful inside @groupby (ref query0_test.go
            # TestGroupByAgg); the executor rejects it elsewhere
            gq.attr = inner.val
            gq.agg_pred = inner.val
            cur.expect("rparen")
            gq.is_internal = True
    elif name == "val" and cur.peek().kind == "lparen":
        cur.next()
        v = cur.expect("name").val
        cur.expect("rparen")
        gq.attr = f"val({v})"
        gq.needs_var.append(VarContext(v, VALUE_VAR))
        gq.is_internal = True
    elif name == "uid" and cur.peek().kind == "lparen":
        cur.next()
        while not cur.accept("rparen"):
            u = cur.next()
            if u.kind in ("hex", "number"):
                gq.uids.append(_to_int(u.val, u.line))
            else:
                gq.needs_var.append(VarContext(u.val, UID_VAR))
            cur.accept("comma")
        gq.attr = "uid"
        gq.is_internal = True
    elif name == "math" and cur.peek().kind == "lparen":
        gq.attr = "math"
        gq.is_internal = True
        gq.math = _parse_math(cur)
    elif name == "expand" and cur.peek().kind == "lparen":
        cur.next()
        t = cur.next()
        gq.attr = "expand"
        gq.expand = t.val  # _all_ | type name(s) | var
        if t.kind == "name" and t.val == "val":
            cur.expect("lparen")
            gq.expand = cur.expect("name").val
            cur.expect("rparen")
        else:
            # expand(CarModel, Object): union of several types'
            # fields (ref query4_test.go
            # TestTypeExpandMultipleExplicitTypes)
            while cur.accept("comma"):
                gq.expand += "," + cur.expect("name").val
        cur.expect("rparen")
    else:
        gq.attr = name
        if cur.peek().kind == "at" and (
                cur.peek(1).kind == "dot"
                or cur.peek(1).val == "*"
                or (cur.peek(1).kind == "name"
                    and cur.peek(1).val.lower() not in _DIRECTIVES)):
            cur.next()
            gq.langs = _parse_langs(cur)

    # argument list (first/offset/after/orderasc/orderdesc)
    if cur.peek().kind == "lparen":
        cur.next()
        while not cur.accept("rparen"):
            key = cur.expect("name", "argument").val
            cur.expect("colon")
            if key in ("first", "offset", "after"):
                _set_pagination(gq, key, _scalar_str(cur, gvars))
            elif key in ("orderasc", "orderdesc"):
                attr, lang = _pred_with_lang_str(cur)
                gq.order.append(
                    Order(attr, desc=(key == "orderdesc"), lang=lang))
            else:
                raise GQLError(f"unknown argument {key!r}")
            cur.accept("comma")

    while cur.peek().kind == "at":
        _parse_directive(cur, gq, gvars)

    if cur.peek().kind == "lbrace":
        cur.next()
        _parse_selection_set(cur, gq, gvars)
    return gq


def _parse_langs(cur: Cursor) -> list[str]:
    # `name@en:fr`, `name@.` (any-language fallback), `name@en:.`,
    # `name@*` (every language as its own output key)
    langs = []
    if cur.accept("dot"):
        langs.append(".")
    elif cur.peek().val == "*":
        cur.next()
        return ["*"]
    else:
        langs.append(cur.expect("name", "language").val)
    while cur.accept("colon"):
        if cur.accept("dot"):
            langs.append(".")
        else:
            langs.append(cur.expect("name", "language").val)
    return langs


# -- math --------------------------------------------------------------------

_MATH_PREC = {
    "+": 1, "-": 1, "*": 2, "/": 2, "%": 2,
    "<": 0, ">": 0, "<=": 0, ">=": 0, "==": 0, "!=": 0,
}
_MATH_FUNCS = {"exp", "ln", "sqrt", "floor", "ceil", "cond", "pow",
               "logbase", "max", "min", "since", "sigmoid"}


def _parse_math(cur: Cursor) -> MathTree:
    cur.expect("lparen")
    tree = _parse_math_expr(cur, 0)
    cur.expect("rparen")
    return tree


def _parse_math_expr(cur: Cursor, min_prec: int) -> MathTree:
    return _parse_math_cont(cur, _parse_math_atom(cur), min_prec)


def _num_const(raw: str) -> MathTree:
    # integer literals stay python ints: int math must be exact
    # beyond 2^53 (ref query4:TestBigMathValue; math.go int64 arm)
    try:
        return MathTree(const=int(raw))
    except ValueError:
        return MathTree(const=float(raw))


def _parse_math_cont(cur: Cursor, left: MathTree,
                     min_prec: int) -> MathTree:
    while True:
        t = cur.peek()
        if t.kind == "number" and t.val.startswith("-") \
                and _MATH_PREC["-"] >= min_prec:
            # `f-2` lexes the literal as negative; after an operand it
            # is binary minus whose RHS STARTS with the positive
            # number — the RHS still binds tighter operators first
            # (f-2*3 == f-(2*3))
            cur.next()
            right = _parse_math_cont(cur, _num_const(t.val[1:]),
                                     _MATH_PREC["-"] + 1)
            left = MathTree(fn="-", children=[left, right])
            continue
        if t.kind == "op" and t.val in _MATH_PREC and _MATH_PREC[t.val] >= min_prec:
            cur.next()
            right = _parse_math_expr(cur, _MATH_PREC[t.val] + 1)
            left = MathTree(fn=t.val, children=[left, right])
        else:
            return left


def _parse_math_atom(cur: Cursor) -> MathTree:
    t = cur.next()
    if t.kind == "lparen":
        e = _parse_math_expr(cur, 0)
        cur.expect("rparen")
        return e
    if t.kind == "number":
        return _num_const(t.val)
    if t.kind == "name":
        if t.val in _MATH_FUNCS and cur.peek().kind == "lparen":
            cur.next()
            node = MathTree(fn=t.val)
            while not cur.accept("rparen"):
                node.children.append(_parse_math_expr(cur, 0))
                cur.accept("comma")
            return node
        if t.val == "val" and cur.peek().kind == "lparen":
            cur.next()
            v = cur.expect("name").val
            cur.expect("rparen")
            return MathTree(var=v)
        return MathTree(var=t.val)
    raise GQLError(f"line {t.line}: bad math expression at {t.val!r}")


# -- post-processing ---------------------------------------------------------


def _expand_fragments(gq: GraphQuery, fragments: dict, seen: set):
    out = []
    for child in gq.children:
        if child.attr.startswith("fragment/"):
            fname = child.attr.split("/", 1)[1]
            if fname in seen:
                raise GQLError(f"fragment cycle at {fname}")
            frag = fragments.get(fname)
            if frag is None:
                raise GQLError(f"missing fragment {fname}")
            _expand_fragments(frag, fragments, seen | {fname})
            out.extend(frag.children)
        else:
            _expand_fragments(child, fragments, seen)
            out.append(child)
    gq.children = out


def _collect_needs(gq: GraphQuery, res: ParsedResult):
    for vc in gq.needs_var:
        res.query_vars.append(vc.name)
    if gq.func:
        for vc in gq.func.needs_var:
            res.query_vars.append(vc.name)
    if gq.filter:
        _collect_filter_needs(gq.filter, res)
    for c in gq.children:
        _collect_needs(c, res)


def _collect_filter_needs(ft: FilterTree, res: ParsedResult):
    if ft.func:
        for vc in ft.func.needs_var:
            res.query_vars.append(vc.name)
    for c in ft.children:
        _collect_filter_needs(c, res)
