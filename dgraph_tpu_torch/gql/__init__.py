"""GraphQL± front-end: lexer, AST, parser, mutation (RDF/JSON) parsing.

Re-provides the reference's `gql/` + `lex/` packages (gql/parser.go:524
Parse, gql/parser_mutation.go:26 ParseMutation) as a Python recursive-
descent parser. Pure library: no dependencies on the engine below it.
"""

from dgraph_tpu_torch.gql.ast import (
    Arg,
    FilterTree,
    Function,
    GraphQuery,
    Order,
    ParsedResult,
    RecurseArgs,
    ShortestArgs,
    VarContext,
)
from dgraph_tpu_torch.gql.parser import GQLError, parse
from dgraph_tpu_torch.gql.nquad import NQuad, parse_rdf, parse_json_mutation
