from eesen_tpu_torch.recipes.config import RecipeConfig, RECIPES
from eesen_tpu_torch.recipes.labels import prep_ctc_trans, lexicon_numbers

__all__ = ["RecipeConfig", "RECIPES", "prep_ctc_trans", "lexicon_numbers"]
