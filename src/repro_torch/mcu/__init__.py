from .interpreter import InterpreterReport, MicroInterpreter
from .compile import (CompiledExecutor, LoweringCtx, compile_schedule,
                      lower_op, register_lowering)

__all__ = ["MicroInterpreter", "InterpreterReport",
           "CompiledExecutor", "LoweringCtx", "compile_schedule",
           "lower_op", "register_lowering"]
