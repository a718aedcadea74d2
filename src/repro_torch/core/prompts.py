"""Instruction templates (realistic ~50-token system prompts, matching the
paper's setting where partial prefilling of instructions is worthwhile)."""

_GUIDELINES = ("You must answer faithfully using only the provided "
               "material, cite the supporting fragment for every claim, "
               "refuse speculation, keep the answer concise and structured, "
               "and preserve any numeric values exactly as written in the "
               "source text without rounding or reformatting them.")

INSTRUCTIONS = {
    "expand": "Rewrite the user question into several diverse standalone "
              "search queries that cover different phrasings and aspects "
              "of the information need. " + _GUIDELINES,
    "judge": "Draft a short candidate answer from parametric knowledge and "
             "output the token SEARCH if external evidence is required to "
             "answer reliably. " + _GUIDELINES,
    "contextualize": "Write a short situating context for the following "
                     "document chunk so it can be understood in isolation. "
                     + _GUIDELINES,
    "oneshot": "Answer the user question using the retrieved context "
               "passages below. " + _GUIDELINES,
    "refine": "Refine the existing candidate answer given one additional "
              "retrieved context passage. " + _GUIDELINES,
    "tree": "Answer the user question using this single retrieved context "
            "passage. " + _GUIDELINES,
    "combine": "Combine the candidate answers into one final answer. "
               + _GUIDELINES,
}
