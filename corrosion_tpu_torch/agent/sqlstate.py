"""PostgreSQL SQLSTATE error codes + the sqlite→SQLSTATE mapping.

Parity: ``crates/corro-pg/src/sql_state.rs`` — the reference carries
the full PG error-code table and tags every ErrorResponse with the
right class.  This module is the same idea in two parts:

* ``SQLSTATE``: name → five-char code, covering every class (00-XX)
  and the condition names the wire actually emits (drivers switch on
  these — e.g. psycopg maps 23505 to ``UniqueViolation``, SQLAlchemy
  retries on 40001/40P01, ORMs surface 23502/23503 as field errors);
* :func:`sqlstate_for`: map a raised exception — usually a
  ``sqlite3.Error``, whose message text is the only classification
  sqlite offers — onto the PG code a real server would send for the
  same fault.

``PgError`` carries an explicit code through the session layer so
protocol-level faults (unknown portal, cancel, feature gaps) do not
collapse into a generic syntax error.
"""

from __future__ import annotations

import sqlite3

# name -> code, grouped by PG error class (Appendix A of the PG docs;
# the reference's sql_state.rs carries the same table as constants)
SQLSTATE = {
    # 00/01/02 — success, warning, no data
    "successful_completion": "00000",
    "warning": "01000",
    "no_data": "02000",
    # 03/08 — SQL-statement-not-yet-complete, connection exceptions
    "sql_statement_not_yet_complete": "03000",
    "connection_exception": "08000",
    "connection_does_not_exist": "08003",
    "connection_failure": "08006",
    "sqlclient_unable_to_establish_sqlconnection": "08001",
    "sqlserver_rejected_establishment_of_sqlconnection": "08004",
    "transaction_resolution_unknown": "08007",
    "protocol_violation": "08P01",
    # 0A — feature not supported
    "feature_not_supported": "0A000",
    # 0B/0F/0L/0P — invalid transaction initiation, locator, grantor
    "invalid_transaction_initiation": "0B000",
    "locator_exception": "0F000",
    "invalid_grantor": "0L000",
    "invalid_role_specification": "0P000",
    # 20/21 — case not found, cardinality violation
    "case_not_found": "20000",
    "cardinality_violation": "21000",
    # 22 — data exceptions
    "data_exception": "22000",
    "string_data_right_truncation": "22001",
    "null_value_no_indicator_parameter": "22002",
    "numeric_value_out_of_range": "22003",
    "null_value_not_allowed": "22004",
    "error_in_assignment": "22005",
    "invalid_datetime_format": "22007",
    "datetime_field_overflow": "22008",
    "invalid_time_zone_displacement_value": "22009",
    "escape_character_conflict": "2200B",
    "invalid_use_of_escape_character": "2200C",
    "invalid_escape_octet": "2200D",
    "zero_length_character_string": "2200F",
    "most_specific_type_mismatch": "2200G",
    "not_an_xml_document": "2200L",
    "invalid_xml_document": "2200M",
    "invalid_argument_for_logarithm": "2201E",
    "invalid_argument_for_ntile_function": "22014",
    "invalid_argument_for_nth_value_function": "22016",
    "invalid_argument_for_power_function": "2201F",
    "invalid_argument_for_width_bucket_function": "2201G",
    "invalid_row_count_in_limit_clause": "2201W",
    "invalid_row_count_in_result_offset_clause": "2201X",
    "character_not_in_repertoire": "22021",
    "indicator_overflow": "22022",
    "invalid_parameter_value": "22023",
    "unterminated_c_string": "22024",
    "invalid_escape_sequence": "22025",
    "string_data_length_mismatch": "22026",
    "trim_error": "22027",
    "array_subscript_error": "2202E",
    "floating_point_exception": "22P01",
    "invalid_text_representation": "22P02",
    "invalid_binary_representation": "22P03",
    "bad_copy_file_format": "22P04",
    "untranslatable_character": "22P05",
    "nonstandard_use_of_escape_character": "22P06",
    "division_by_zero": "22012",
    # 23 — integrity constraint violations
    "integrity_constraint_violation": "23000",
    "restrict_violation": "23001",
    "not_null_violation": "23502",
    "foreign_key_violation": "23503",
    "unique_violation": "23505",
    "check_violation": "23514",
    "exclusion_violation": "23P01",
    # 24/25 — invalid cursor/transaction state
    "invalid_cursor_state": "24000",
    "invalid_transaction_state": "25000",
    "active_sql_transaction": "25001",
    "branch_transaction_already_active": "25002",
    "inappropriate_access_mode_for_branch_transaction": "25003",
    "inappropriate_isolation_level_for_branch_transaction": "25004",
    "no_active_sql_transaction_for_branch_transaction": "25005",
    "read_only_sql_transaction": "25006",
    "schema_and_data_statement_mixing_not_supported": "25007",
    "held_cursor_requires_same_isolation_level": "25008",
    "no_active_sql_transaction": "25P01",
    "in_failed_sql_transaction": "25P02",
    "idle_in_transaction_session_timeout": "25P03",
    # 26/27/28 — invalid statement name, triggered data change, authz
    "invalid_sql_statement_name": "26000",
    "triggered_data_change_violation": "27000",
    "invalid_authorization_specification": "28000",
    "invalid_password": "28P01",
    # 2B/2D/2F — dependent objects, transaction termination, SQL routine
    "dependent_privilege_descriptors_still_exist": "2B000",
    "dependent_objects_still_exist": "2BP01",
    "invalid_transaction_termination": "2D000",
    "sql_routine_exception": "2F000",
    # 34 — invalid cursor name
    "invalid_cursor_name": "34000",
    # 38/39/3B/3D/3F — external routine, savepoint, catalog, schema
    "external_routine_exception": "38000",
    "external_routine_invocation_exception": "39000",
    "savepoint_exception": "3B000",
    "invalid_savepoint_specification": "3B001",
    "invalid_catalog_name": "3D000",
    "invalid_schema_name": "3F000",
    # 40 — transaction rollback
    "transaction_rollback": "40000",
    "transaction_integrity_constraint_violation": "40002",
    "serialization_failure": "40001",
    "statement_completion_unknown": "40003",
    "deadlock_detected": "40P01",
    # 42 — syntax error or access rule violation
    "syntax_error_or_access_rule_violation": "42000",
    "syntax_error": "42601",
    "insufficient_privilege": "42501",
    "cannot_coerce": "42846",
    "grouping_error": "42803",
    "windowing_error": "42P20",
    "invalid_recursion": "42P19",
    "invalid_foreign_key": "42830",
    "invalid_name": "42602",
    "name_too_long": "42622",
    "reserved_name": "42939",
    "datatype_mismatch": "42804",
    "indeterminate_datatype": "42P18",
    "collation_mismatch": "42P21",
    "indeterminate_collation": "42P22",
    "wrong_object_type": "42809",
    "undefined_column": "42703",
    "undefined_function": "42883",
    "undefined_table": "42P01",
    "undefined_parameter": "42P02",
    "undefined_object": "42704",
    "duplicate_column": "42701",
    "duplicate_cursor": "42P03",
    "duplicate_database": "42P04",
    "duplicate_function": "42723",
    "duplicate_prepared_statement": "42P05",
    "duplicate_schema": "42P06",
    "duplicate_table": "42P07",
    "duplicate_alias": "42712",
    "duplicate_object": "42710",
    "ambiguous_column": "42702",
    "ambiguous_function": "42725",
    "ambiguous_parameter": "42P08",
    "ambiguous_alias": "42P09",
    "invalid_column_reference": "42P10",
    "invalid_column_definition": "42611",
    "invalid_cursor_definition": "42P11",
    "invalid_database_definition": "42P12",
    "invalid_function_definition": "42P13",
    "invalid_prepared_statement_definition": "42P14",
    "invalid_schema_definition": "42P15",
    "invalid_table_definition": "42P16",
    "invalid_object_definition": "42P17",
    # 53/54/55/57/58 — resources, limits, object state, operator
    # intervention, system errors
    "insufficient_resources": "53000",
    "disk_full": "53100",
    "out_of_memory": "53200",
    "too_many_connections": "53300",
    "configuration_limit_exceeded": "53400",
    "program_limit_exceeded": "54000",
    "statement_too_complex": "54001",
    "too_many_columns": "54011",
    "too_many_arguments": "54023",
    "object_not_in_prerequisite_state": "55000",
    "object_in_use": "55006",
    "cant_change_runtime_param": "55P02",
    "lock_not_available": "55P03",
    "operator_intervention": "57000",
    "query_canceled": "57014",
    "admin_shutdown": "57P01",
    "crash_shutdown": "57P02",
    "cannot_connect_now": "57P03",
    "database_dropped": "57P04",
    "system_error": "58000",
    "io_error": "58030",
    "undefined_file": "58P01",
    "duplicate_file": "58P02",
    # F0/HV/P0/XX — config file, FDW, PL/pgSQL, internal
    "config_file_error": "F0000",
    "lock_file_exists": "F0001",
    "fdw_error": "HV000",
    "plpgsql_error": "P0000",
    "raise_exception": "P0001",
    "no_data_found": "P0002",
    "too_many_rows": "P0003",
    "assert_failure": "P0004",
    "internal_error": "XX000",
    "data_corrupted": "XX001",
    "index_corrupted": "XX002",
}


class PgError(Exception):
    """An error with an explicit SQLSTATE, raised by the session layer
    for conditions sqlite cannot name (cancelled queries, transaction
    misuse, unsupported features)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


# sqlite message fragment -> SQLSTATE name (checked in order; first
# match wins — sqlite3.Error carries no machine-readable subcode for
# most of these, so the text IS the classification, exactly what the
# stdlib's own exception mapping does)
_SQLITE_PATTERNS = (
    ("no such table", "undefined_table"),
    ("no such column", "undefined_column"),
    ("no such function", "undefined_function"),
    ("no such index", "undefined_object"),
    ("no such savepoint", "invalid_savepoint_specification"),
    ("already exists", "duplicate_table"),
    ("duplicate column name", "duplicate_column"),
    ("ambiguous column name", "ambiguous_column"),
    ("unique constraint failed", "unique_violation"),
    ("not null constraint failed", "not_null_violation"),
    ("check constraint failed", "check_violation"),
    ("foreign key constraint failed", "foreign_key_violation"),
    ("datatype mismatch", "datatype_mismatch"),
    ("syntax error", "syntax_error"),
    ("unrecognized token", "syntax_error"),
    ("incomplete input", "syntax_error"),
    ("wrong number of arguments", "undefined_function"),
    ("too many terms in compound select", "statement_too_complex"),
    ("too many columns", "too_many_columns"),
    ("string or blob too big", "program_limit_exceeded"),
    ("database or disk is full", "disk_full"),
    ("out of memory", "out_of_memory"),
    ("interrupted", "query_canceled"),
    ("database is locked", "lock_not_available"),
    ("attempt to write a readonly database", "read_only_sql_transaction"),
    ("readonly database", "read_only_sql_transaction"),
    ("database disk image is malformed", "data_corrupted"),
)


def sqlstate_for(exc: BaseException) -> str:
    """The SQLSTATE a real PG server would send for this fault."""
    if isinstance(exc, PgError):
        return exc.code
    msg = str(exc).lower()
    if isinstance(exc, sqlite3.IntegrityError):
        for frag, name in _SQLITE_PATTERNS:
            if frag in msg:
                return SQLSTATE[name]
        return SQLSTATE["integrity_constraint_violation"]
    if isinstance(exc, sqlite3.Error):
        for frag, name in _SQLITE_PATTERNS:
            if frag in msg:
                return SQLSTATE[name]
        return SQLSTATE["internal_error"] if isinstance(
            exc, sqlite3.InternalError
        ) else SQLSTATE["syntax_error"]
    if isinstance(exc, (ValueError, TypeError)):
        return SQLSTATE["invalid_text_representation"]
    return SQLSTATE["internal_error"]
