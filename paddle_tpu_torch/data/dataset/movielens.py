"""MovieLens-1M (python/paddle/v2/dataset/movielens.py): each sample is
user features + movie features + [[rating]]:
[user_id, gender_id, age_id, job_id, movie_id, category_ids(multi-hot
list), title_ids(list), [rating]] (movielens.py:159 usr.value() +
mov.value() + [[rating]]). Helpers: movie_categories, max_user_id,
max_movie_id, max_job_id, age_table."""

from __future__ import annotations

from paddle_tpu_torch.data.dataset import common

__all__ = [
    "convert",
    "train",
    "test",
    "movie_categories",
    "max_user_id",
    "max_movie_id",
    "max_job_id",
    "age_table",
    "get_movie_title_dict",
]

_CATEGORIES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 400
_N_MOVIES = 300
_N_JOBS = 21
_TITLE_VOCAB = 100


def movie_categories():
    return {c: i for i, c in enumerate(_CATEGORIES)}


def get_movie_title_dict():
    return {f"t{i}": i for i in range(_TITLE_VOCAB)}


def max_user_id():
    return _N_USERS


def max_movie_id():
    return _N_MOVIES


def max_job_id():
    return _N_JOBS - 1


def _creator(split_name, n):
    def reader():
        rng = common.synthetic_rng("movielens", split_name)
        for _ in range(n):
            user = int(rng.integers(1, _N_USERS + 1))
            gender = int(rng.integers(0, 2))
            age = int(rng.integers(0, len(age_table)))
            job = int(rng.integers(0, _N_JOBS))
            movie = int(rng.integers(1, _N_MOVIES + 1))
            cats = rng.choice(
                len(_CATEGORIES), size=int(rng.integers(1, 4)),
                replace=False,
            ).tolist()
            title = rng.integers(
                0, _TITLE_VOCAB, int(rng.integers(1, 6))
            ).tolist()
            # rating correlates with (user+movie) parity so models learn
            base = 3.0 + ((user + movie) % 3 - 1)
            rating = float(min(5, max(1, round(base + rng.normal(0, 0.5)))))
            yield [user, gender, age, job, movie, cats, title, [rating]]

    return reader


def train():
    return _creator("train", 1024)


def test():
    return _creator("test", 256)


def convert(path):
    """Write the dataset as chunked recordio files for the cloud/
    elastic-master input path (reference movielens.py convert;
    common.convert -> go/master RecordIO tasks).
    """
    common.convert(path, train(), 1000, "movielens_train")
    common.convert(path, test(), 1000, "movielens_test")
